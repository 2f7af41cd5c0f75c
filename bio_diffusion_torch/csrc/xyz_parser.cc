// GDB9 xyz batch parser and dense batch collation, host side (the PyTorch
// package's copy of native/xyz_parser.cc).
//
// The QM9 preparation step parses ~134k xyz records; the reference does it
// in pure Python (src/datamodules/components/edm/process.py).  This parser
// handles a whole batch of records in one call over a contiguous buffer,
// exposed through a C interface for ctypes.
//
// GDB9 record layout (process_xyz_gdb9 semantics):
//   line 0: natoms
//   line 1: "gdb <index> <A> <B> <C> <mu> <alpha> <homo> <lumo> <gap> <r2>
//            <zpve> <U0> <U> <H> <G> <Cv>"
//   lines 2..natoms+1: "<El> <x> <y> <z> <mulliken>" ("*^" == "e" exponent)
//   line natoms+2: harmonic frequencies (max -> omega1)
//
// Built on first use by bio_diffusion_torch/ops/build.py::compile_host_source
// (g++ -O3 -fPIC -shared -std=c++17) into bio_diffusion_torch/build/.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cctype>

namespace {

struct Cursor {
  const char* p;
  const char* end;
};

inline void skip_ws(Cursor& c) {
  while (c.p < c.end && (*c.p == ' ' || *c.p == '\t' || *c.p == '\r')) ++c.p;
}

inline void skip_line(Cursor& c) {
  while (c.p < c.end && *c.p != '\n') ++c.p;
  if (c.p < c.end) ++c.p;
}

// parse a float token, translating the GDB9 "*^" exponent marker to 'e'
inline bool parse_double(Cursor& c, double* out) {
  skip_ws(c);
  char buf[64];
  int n = 0;
  while (c.p < c.end && n < 63) {
    char ch = *c.p;
    if (ch == ' ' || ch == '\t' || ch == '\n' || ch == '\r') break;
    if (ch == '*' && c.p + 1 < c.end && c.p[1] == '^') {
      buf[n++] = 'e';
      c.p += 2;
      continue;
    }
    buf[n++] = ch;
    ++c.p;
  }
  if (n == 0) return false;
  buf[n] = 0;
  char* endp = nullptr;
  *out = strtod(buf, &endp);
  return endp != buf;
}

inline bool parse_long(Cursor& c, int64_t* out) {
  double d;
  if (!parse_double(c, &d)) return false;
  *out = static_cast<int64_t>(d);
  return true;
}

// element symbol -> atomic number (QM9 elements)
inline int64_t element_z(Cursor& c) {
  skip_ws(c);
  if (c.p >= c.end) return -1;
  char a = *c.p++;
  char b = (c.p < c.end && isalpha(*c.p)) ? *c.p : 0;
  if (b) ++c.p;
  if (a == 'H' && !b) return 1;
  if (a == 'C' && !b) return 6;
  if (a == 'N' && !b) return 7;
  if (a == 'O' && !b) return 8;
  if (a == 'F' && !b) return 9;
  return -1;
}

}  // namespace

extern "C" {

// Parse n_mols xyz records located at offsets[i]..offsets[i]+lengths[i] in buf.
// Outputs (caller-allocated):
//   positions [n_mols, max_atoms, 3] double
//   charges   [n_mols, max_atoms]   int64
//   props     [n_mols, 17]          double  (index, A..Cv, omega1)
//   n_atoms   [n_mols]              int64
// Returns number of successfully parsed molecules; failed records get
// n_atoms[i] = -1.
int64_t parse_gdb9_batch(
    const char* buf, const int64_t* offsets, const int64_t* lengths,
    int64_t n_mols, int64_t max_atoms,
    double* positions, int64_t* charges, double* props, int64_t* n_atoms) {
  int64_t ok = 0;
  for (int64_t m = 0; m < n_mols; ++m) {
    Cursor c{buf + offsets[m], buf + offsets[m] + lengths[m]};
    n_atoms[m] = -1;
    int64_t na;
    if (!parse_long(c, &na) || na <= 0 || na > max_atoms) { continue; }
    skip_line(c);

    // properties line: tag ("gdb") index A B C mu alpha homo lumo gap r2
    // zpve U0 U H G Cv
    skip_ws(c);
    while (c.p < c.end && !isspace(*c.p)) ++c.p;  // skip "gdb" tag
    double* pr = props + m * 17;
    bool bad = false;
    for (int k = 0; k < 16; ++k) {
      if (!parse_double(c, &pr[k])) { bad = true; break; }
    }
    if (bad) continue;
    skip_line(c);

    double* pos = positions + m * max_atoms * 3;
    int64_t* chg = charges + m * max_atoms;
    for (int64_t a = 0; a < na && !bad; ++a) {
      int64_t z = element_z(c);
      if (z < 0) { bad = true; break; }
      chg[a] = z;
      double x, y, zz, mull;
      if (!parse_double(c, &x) || !parse_double(c, &y) || !parse_double(c, &zz) ||
          !parse_double(c, &mull)) { bad = true; break; }
      pos[a * 3 + 0] = x;
      pos[a * 3 + 1] = y;
      pos[a * 3 + 2] = zz;
      skip_line(c);
    }
    if (bad) continue;

    // frequencies line -> omega1 = max
    double omega1 = -1e300, f;
    Cursor fl = c;
    while (parse_double(fl, &f)) {
      if (f > omega1) omega1 = f;
      skip_ws(fl);
      if (fl.p < fl.end && *fl.p == '\n') break;
    }
    pr[16] = omega1;

    n_atoms[m] = na;
    ++ok;
  }
  return ok;
}

// Dense padded collation: gather selected molecules into padded batch
// tensors (float32 x / one_hot / mask) in one pass.
//   positions_src [M, n_src, 3] double; charges_src [M, n_src] int64
//   sel [B] int64 ; species [K] int64
//   x [B, n_pad, 3] float ; one_hot [B, n_pad, K] float ;
//   charges [B, n_pad] float ; mask [B, n_pad] float
void collate_dense_batch(
    const double* positions_src, const int64_t* charges_src,
    int64_t n_src, const int64_t* sel, int64_t b, int64_t n_pad,
    const int64_t* species, int64_t k,
    float* x, float* one_hot, float* charges, float* mask) {
  const int64_t n_copy = n_src < n_pad ? n_src : n_pad;
  memset(x, 0, sizeof(float) * b * n_pad * 3);
  memset(one_hot, 0, sizeof(float) * b * n_pad * k);
  memset(charges, 0, sizeof(float) * b * n_pad);
  memset(mask, 0, sizeof(float) * b * n_pad);
  for (int64_t i = 0; i < b; ++i) {
    const int64_t src = sel[i];
    const double* ps = positions_src + src * n_src * 3;
    const int64_t* cs = charges_src + src * n_src;
    for (int64_t a = 0; a < n_copy; ++a) {
      const int64_t z = cs[a];
      if (z <= 0) continue;
      mask[i * n_pad + a] = 1.0f;
      charges[i * n_pad + a] = static_cast<float>(z);
      x[(i * n_pad + a) * 3 + 0] = static_cast<float>(ps[a * 3 + 0]);
      x[(i * n_pad + a) * 3 + 1] = static_cast<float>(ps[a * 3 + 1]);
      x[(i * n_pad + a) * 3 + 2] = static_cast<float>(ps[a * 3 + 2]);
      for (int64_t s = 0; s < k; ++s) {
        if (species[s] == z) {
          one_hot[(i * n_pad + a) * k + s] = 1.0f;
          break;
        }
      }
    }
  }
}

}  // extern "C"

"""Chemical constants: empirical bond-length tables and valences.

Copy of ``bio_diffusion_tpu/chem/constants.py`` (the port imports nothing of
the JAX package).

These are empirical data tables (bond lengths in picometers from
wiredchemist.com / chemistry-reference.com), identical to the values the
reference uses (src/datamodules/components/edm/constants.py:20-94) — parity
of the stability metric requires the exact same numbers.
"""

# distance margins (pm) for assigning single/double/triple bonds
MARGIN1, MARGIN2, MARGIN3 = 10, 5, 3

# allowed valences per element; a list means multiple allowed valences
ALLOWED_BONDS = {
    "H": 1, "C": 4, "N": 3, "O": 2, "F": 1, "B": 3, "Al": 3,
    "Si": 4, "P": [3, 5], "S": 4, "Cl": 1, "As": 3, "Br": 1, "I": 1,
    "Hg": [1, 2], "Bi": [3, 5],
}

# single-bond lengths (pm)
BONDS1 = {
    "H": {"H": 74, "C": 109, "N": 101, "O": 96, "F": 92, "B": 119, "Si": 148,
          "P": 144, "As": 152, "S": 134, "Cl": 127, "Br": 141, "I": 161},
    "C": {"H": 109, "C": 154, "N": 147, "O": 143, "F": 135, "Si": 185,
          "P": 184, "S": 182, "Cl": 177, "Br": 194, "I": 214},
    "N": {"H": 101, "C": 147, "N": 145, "O": 140, "F": 136, "Cl": 175,
          "Br": 214, "S": 168, "I": 222, "P": 177},
    "O": {"H": 96, "C": 143, "N": 140, "O": 148, "F": 142, "Br": 172,
          "S": 151, "P": 163, "Si": 163, "Cl": 164, "I": 194},
    "F": {"H": 92, "C": 135, "N": 136, "O": 142, "F": 142, "S": 158,
          "Si": 160, "Cl": 166, "Br": 178, "P": 156, "I": 187},
    "B": {"H": 119, "Cl": 175},
    "Si": {"Si": 233, "H": 148, "C": 185, "O": 163, "S": 200, "F": 160,
           "Cl": 202, "Br": 215, "I": 243},
    "Cl": {"Cl": 199, "H": 127, "C": 177, "N": 175, "O": 164, "P": 203,
           "S": 207, "B": 175, "Si": 202, "F": 166, "Br": 214},
    "S": {"H": 134, "C": 182, "N": 168, "O": 151, "S": 204, "F": 158,
          "Cl": 207, "Br": 225, "Si": 200, "P": 210, "I": 234},
    "Br": {"Br": 228, "H": 141, "C": 194, "O": 172, "N": 214, "Si": 215,
           "S": 225, "F": 178, "Cl": 214, "P": 222},
    "P": {"P": 221, "H": 144, "C": 184, "O": 163, "Cl": 203, "S": 210,
          "F": 156, "N": 177, "Br": 222},
    "I": {"H": 161, "C": 214, "Si": 243, "N": 222, "O": 194, "S": 234,
          "F": 187, "I": 266},
    "As": {"H": 152},
}

# double-bond lengths (pm)
BONDS2 = {
    "C": {"C": 134, "N": 129, "O": 120, "S": 160},
    "N": {"C": 129, "N": 125, "O": 121},
    "O": {"C": 120, "N": 121, "O": 121, "P": 150},
    "P": {"O": 150, "S": 186},
    "S": {"P": 186, "C": 160},
}

# triple-bond lengths (pm)
BONDS3 = {
    "C": {"C": 120, "N": 116, "O": 113},
    "N": {"C": 116, "N": 110},
    "O": {"C": 113},
}

# atomic numbers of the elements QM9 uses
CHARGE_DICT = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9}

"""ScalarVector: the (invariant, equivariant) feature pair of GCPNet.

Port of ``bio_diffusion_tpu/ops/scalar_vector.py``: ``scalar [..., S]`` and
``vector [..., V, 3]`` over any leading dims (``[B, N]`` for nodes, ``[B, N,
N]`` for edges).  The GCP modules compute in the coords-major layout
``[..., 3, V]`` (:attr:`ScalarVector.vector_cm`, :meth:`ScalarVector.from_cm`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class ScalarVector(NamedTuple):
    scalar: Tensor  # [..., S]
    vector: Tensor  # [..., V, 3]

    def __add__(self, other: "ScalarVector") -> "ScalarVector":  # type: ignore[override]
        return ScalarVector(self.scalar + other.scalar, self.vector + other.vector)

    def concat(self, *others: "ScalarVector") -> "ScalarVector":
        """Channels of ``self`` then of each of ``others``."""
        parts = (self,) + others
        return ScalarVector(torch.cat([p.scalar for p in parts], dim=-1),
                            torch.cat([p.vector for p in parts], dim=-2))

    def flatten(self) -> Tensor:
        """One ``[..., S + 3V]`` tensor: the scalars, then the vectors row-major."""
        v = self.vector
        return torch.cat([self.scalar, v.reshape(v.shape[:-2] + (v.shape[-2] * 3,))], dim=-1)

    @staticmethod
    def recover(x: Tensor, vector_dim: int) -> "ScalarVector":
        """The inverse of :meth:`flatten` for ``vector_dim`` vector channels."""
        if vector_dim == 0:
            return ScalarVector(x, x.new_zeros(x.shape[:-1] + (0, 3)))
        v = x[..., x.shape[-1] - 3 * vector_dim:].reshape(x.shape[:-1] + (vector_dim, 3))
        return ScalarVector(x[..., :x.shape[-1] - 3 * vector_dim], v)

    def mask(self, node_mask: Tensor) -> "ScalarVector":
        """Zero the entities where ``node_mask`` (the leading dims) is 0."""
        m = node_mask.to(self.scalar.dtype)
        return ScalarVector(self.scalar * m[..., None], self.vector * m[..., None, None].to(self.vector.dtype))

    @property
    def vector_cm(self) -> Tensor:
        """The vectors coords-major, ``[..., 3, V]``."""
        return self.vector.transpose(-1, -2)

    @staticmethod
    def from_cm(scalar: Tensor, vector_cm: Tensor) -> "ScalarVector":
        return ScalarVector(scalar, vector_cm.transpose(-1, -2))

"""Generic iterated error-state EKF on manifold compositions, torch port of
`rolo_tpu/filter/manifold.py` (the IKFoM toolkit's vect / SO3 / S2
manifolds, MTK_BUILD_MANIFOLD and esekf's predict / update_iterated).

A state is declared as (name -> manifold) pairs over a dict of tensors.
Every Jacobian comes from forward-mode autodiff through boxminus:
F = d/d(dx) [ f(x ⊞ dx) ⊟ f(x) ] at dx = 0 (`torch.func.jacfwd`), H likewise
in the measurement manifold. The zero tangent is where so3.exp clamps θ²
and so3.log and S2's boxminus take their small-angle branches, each a
double `where`, so the tangents there come out finite. The user's `process`
and `measure` callables must be functional under `jacfwd`: no in-place
writes, no `.item()`, no Python branch on a tensor. Forward-mode autodiff
promotes a 0-dim f32 tangent combined with a Python float to f64, so the
primitives keep their intermediates at least one-dimensional (so3.exp and
so3.log do so for unbatched arguments).

`filter/eskf.py` stays the specialized 18-DoF pose filter of the hot path;
the tests pin this generic machinery against it.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence, Tuple

import torch

from ..geometry import so3


class Vect(NamedTuple):
    """R^n with additive boxplus."""

    n: int

    @property
    def dim(self) -> int:
        return self.n

    def boxplus(self, x, dx):
        return x + dx

    def boxminus(self, a, b):
        return a - b


class SO3(NamedTuple):
    """Rotation matrices with right tangent perturbation: R' = R Exp(dθ)."""

    @property
    def dim(self) -> int:
        return 3

    def boxplus(self, x, dx):
        return x @ so3.exp(dx)

    def boxminus(self, a, b):
        return so3.log(b.T @ a)


class S2(NamedTuple):
    """Unit vectors in R^3 with a 2-dof tangent: the basis at x spans x^⊥,
    and boxplus rotates x by Exp(B(x) δ)."""

    @property
    def dim(self) -> int:
        return 2

    @staticmethod
    def _basis(x):
        """[3, 2] orthonormal basis of the tangent plane at unit x."""
        e = torch.where(torch.abs(x[0]) < 0.9,
                        torch.tensor([1.0, 0.0, 0.0], dtype=x.dtype, device=x.device),
                        torch.tensor([0.0, 1.0, 0.0], dtype=x.dtype, device=x.device))
        b1 = torch.linalg.cross(x, e)
        b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1, dim=-1, keepdim=True), min=1e-12)
        b2 = torch.linalg.cross(x, b1)
        return torch.stack([b1, b2], dim=-1)

    def boxplus(self, x, dx):
        return so3.exp(self._basis(x) @ dx) @ x

    def boxminus(self, a, b):
        # the rotation taking b to a in b's tangent basis; at a == b (the
        # linearization point) |v| has no derivative, so the small branch
        # returns the first-order w = v, double-where guarded (manifold.py:91-103)
        v = torch.linalg.cross(b, a)
        s2 = torch.sum(v * v, dim=-1, keepdim=True)
        small = s2 < 1e-12
        s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
        c = torch.clamp(torch.sum(a * b, dim=-1, keepdim=True), -1.0, 1.0)
        ang = torch.atan2(s, c)
        w = torch.where(small, v, (ang / s) * v)
        return self._basis(b).T @ w


Declaration = Sequence[Tuple[str, object]]


def tangent_dim(decl: Declaration) -> int:
    return sum(m.dim for m in dict(decl).values())


def boxplus(decl: Declaration, x: Dict, dx: torch.Tensor) -> Dict:
    """x ⊞ dx over the composite tangent."""
    out = dict(x)
    off = 0
    for name, m in decl:
        out[name] = m.boxplus(x[name], dx[off:off + m.dim])
        off += m.dim
    return out


def boxminus(decl: Declaration, a: Dict, b: Dict) -> torch.Tensor:
    """a ⊟ b -> composite tangent vector."""
    return torch.cat([m.boxminus(a[name], b[name]).reshape(-1) for name, m in decl])


def _jac_through_boxminus(decl_out, decl_in, fn, x):
    """d/d(dx) [ fn(x ⊞ dx) ⊟ fn(x) ] at dx = 0 (manifold.py:131-139)."""
    fx = fn(x)

    def local(dx):
        return boxminus(decl_out, fn(boxplus(decl_in, x, dx)), fx)

    leaf = next(iter(x.values()))
    zero = torch.zeros(tangent_dim(decl_in), dtype=leaf.dtype, device=leaf.device)
    return torch.func.jacfwd(local)(zero)


class GenericEKF(NamedTuple):
    """A declared filter: the state manifold and the process / measurement
    models. process(x, dt) -> x; measure(x) -> z dict in `meas_decl`."""

    decl: Declaration
    process: Callable
    measure: Callable
    meas_decl: Declaration


def predict(ekf: GenericEKF, x: Dict, p: torch.Tensor, q: torch.Tensor, dt
            ) -> Tuple[Dict, torch.Tensor]:
    """Mean propagation and F P Fᵀ + Q with F by autodiff (manifold.py:159-164)."""
    def f(s):
        return ekf.process(s, dt)

    fjac = _jac_through_boxminus(ekf.decl, ekf.decl, f, x)
    return f(x), fjac @ p @ fjac.T + q


def update_iterated(ekf: GenericEKF, x: Dict, p: torch.Tensor, z: Dict, r: torch.Tensor,
                    iterations: int = 3) -> Tuple[Dict, torch.Tensor]:
    """Gauss-Newton iterated measurement update (manifold.py:167-201): H is
    relinearized at each iterate and the anchor's error restated in the
    current iterate's tangent, d = dx0 + K (innov - H dx0). The reference's
    `fori_loop` is a Python loop."""
    n = tangent_dim(ekf.decl)
    eye = torch.eye(n, dtype=p.dtype, device=p.device)
    xi, pi = x, p
    for _ in range(iterations):
        h = _jac_through_boxminus(ekf.meas_decl, ekf.decl, ekf.measure, xi)
        innov = boxminus(ekf.meas_decl, z, ekf.measure(xi))
        dx0 = boxminus(ekf.decl, x, xi)
        s = h @ p @ h.T + r
        k = p @ h.T @ torch.linalg.inv(s)
        xi = boxplus(ekf.decl, xi, dx0 + k @ (innov - h @ dx0))
        pi = (eye - k @ h) @ p
    return xi, pi

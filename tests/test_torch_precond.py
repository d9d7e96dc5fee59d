"""Port parity: one apply of the AMG V-cycle, the Schur fieldsplit and the
2-way block preconditioner, porotpu_torch against porotpu on the same
vector, in f64 to 1e-10 relative (summation order differs; a V-cycle
amplifies rounding by the operator's condition, far below this bound).

Each apply is checked twice: on porotpu's objects carried across by
``porotpu_torch.convert`` (tests the apply code) and on the port's own
host build (tests the copied host setup as well — its band offsets,
level counts, shapes and lmax must equal porotpu's).  The configuration
is swelling-3d N=3 with the bench overrides and ``amg coarse size`` 100,
so the solid AMG has two levels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porotpu.models import benchmarks as jbench
from porotpu_torch.convert import to_torch
from porotpu_torch.models.benchmarks import BENCH_OVERRIDES, swelling_3d

torch.set_num_threads(1)

OVERRIDES = dict(BENCH_OVERRIDES, dtype="float64", **{"amg coarse size": 100})


@pytest.fixture(scope="module")
def builds():
    jp = jbench.swelling_3d(3, overrides=OVERRIDES)
    jp._build_operators()
    p = swelling_3d(3, overrides=OVERRIDES, device="cpu")
    p._build_operators()
    return jp, p


def _parts(pc, jax_side):
    """The three applies of a block PC: solid AMG, Schur fieldsplit, whole."""
    if jax_side:
        amg = pc.solve_s.payload["amg"]
    else:
        amg = pc.solve_s.mods["amg"]
    return {"amg_solid": amg, "schur_fieldsplit": pc.solve_fp, "block_pc": pc}


@pytest.fixture(scope="module")
def jax_applies(builds):
    """porotpu's apply of each part on a seeded vector: {part: (x, y)}."""
    jp, _ = builds
    out = {}
    for part, jop in _parts(jp.pc, True).items():
        n = {"amg_solid": jp.ns_p, "schur_fieldsplit": jp.nf_p + jp.np_p}.get(
            part, sum(jp.padded_sizes)
        )
        x = np.random.default_rng(21).normal(size=n)
        out[part] = x, np.asarray(jax.jit(lambda o, v: o(v))(jop, jnp.asarray(x)))
    return out


@pytest.mark.parametrize("source", ["converted", "own_build"])
@pytest.mark.parametrize("part", ["amg_solid", "schur_fieldsplit", "block_pc"])
def test_apply_matches_porotpu_f64(part, source, builds, jax_applies):
    jp, p = builds
    jop = _parts(jp.pc, True)[part]
    op = to_torch(jop) if source == "converted" else _parts(p.pc, False)[part]
    x, want = jax_applies[part]
    with torch.inference_mode():
        got = op(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-10, err


def _desc(op):
    """Storage description of an operator: class, shape, offsets, ne."""
    name = type(op).__name__
    if name == "Transposed":
        return ("T",) + _desc(op.inner)
    if name == "DIA":
        return ("DIA", tuple(op.shape), tuple(op.offsets), op.ne)
    return (name, tuple(op.shape))


@pytest.mark.parametrize("which", ["solid", "fluid", "schur"])
def test_own_host_setup_matches_porotpu(which, builds):
    jp, p = builds
    jamg, amg = {
        "solid": (jp.pc.solve_s.payload["amg"], p.pc.solve_s.mods["amg"]),
        "fluid": (
            jp.pc.solve_fp.solve_f.payload["amg"],
            p.pc.solve_fp.solve_f.mods["amg"],
        ),
        "schur": (
            jp.pc.solve_fp.solve_S.payload["base"].payload["amg"],
            p.pc.solve_fp.solve_S.mods["base"].mods["amg"],
        ),
    }[which]
    if which == "solid":
        assert len(jamg.levels) >= 2
    assert len(amg.levels) == len(jamg.levels)
    for lv, jlv in zip(amg.levels, jamg.levels):
        assert _desc(lv.A) == _desc(jlv.A)
        assert _desc(lv.P) == _desc(jlv.P)
        assert lv.lmax == pytest.approx(jlv.lmax, rel=1e-12)
        np.testing.assert_allclose(lv.dinv.numpy(), np.asarray(jlv.dinv), rtol=1e-12)
    assert tuple(amg.coarse_inv.shape) == tuple(jamg.coarse_inv.shape)
    np.testing.assert_allclose(
        amg.coarse_inv.numpy(), np.asarray(jamg.coarse_inv),
        rtol=1e-9, atol=1e-9 * np.abs(np.asarray(jamg.coarse_inv)).max(),
    )


def test_block_pc_moves_with_to(builds):
    """Every array of the solver state is a registered buffer: a dtype move
    reaches all of them."""
    _, p = builds
    bufs = dict(p.pc.named_buffers())
    assert any(k.endswith(".data") for k in bufs) and any("coarse_inv" in k for k in bufs)
    # f64, as porotpu: no transposed layout, every transpose reads A's own
    assert not any("dataT" in k for k in bufs)
    moved = p.pc.to(torch.float32)
    assert all(
        b.dtype == torch.float32 for b in moved.buffers() if b.is_floating_point()
    )
    moved.to(torch.float64)

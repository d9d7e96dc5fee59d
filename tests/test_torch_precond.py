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


@pytest.fixture(scope="module")
def three_way_builds():
    """The same configuration with the 3-way block PC (``diagonal 3-way``)."""
    over = dict(OVERRIDES, **{"pc type": "diagonal 3-way"})
    jp = jbench.swelling_3d(3, overrides=over)
    jp._build_operators()
    p = swelling_3d(3, overrides=over, device="cpu")
    p._build_operators()
    return jp, p


@pytest.mark.parametrize("source", ["converted", "own_build"])
def test_three_way_apply_matches_porotpu_f64(source, three_way_builds):
    """The 3-way double sweep: pressure and diffusion solves, two fluid
    and two solid solves, the weighted sum; f64 to 1e-12 relative."""
    jp, p = three_way_builds
    assert jp.pc.three_way and jp.pc.diff_rhs_mask is not None
    pc = to_torch(jp.pc) if source == "converted" else p.pc
    assert pc.three_way and (pc.w1, pc.w2) == (jp.pc.w1, jp.pc.w2)
    np.testing.assert_array_equal(pc.diff_rhs_mask.numpy(), np.asarray(jp.pc.diff_rhs_mask))
    assert pc.diff_rhs_mask.numpy().min() == 0.0  # the diffusion BC rows are masked
    x = np.random.default_rng(23).normal(size=sum(jp.padded_sizes))
    want = np.asarray(jax.jit(lambda o, v: o(v))(jp.pc, jnp.asarray(x)))
    with torch.inference_mode():
        got = pc(torch.from_numpy(x)).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert np.isfinite(got).all() and err <= 1e-12, err


@pytest.fixture(scope="module")
def cast_builds():
    """The same configuration with the PC built in f32 under an f64 solve."""
    over = dict(OVERRIDES, **{"pc dtype": "float32"})
    jp = jbench.swelling_3d(3, overrides=over)
    jp._build_operators()
    p = swelling_3d(3, overrides=over, device="cpu")
    p._build_operators()
    return jp, p


@pytest.mark.parametrize("source", ["converted", "own_build"])
def test_cast_pc_apply_matches_porotpu(source, cast_builds):
    """CastPC: f64 in and out, an f32 payload.  Both sides round the same
    f32 V-cycles in another summation order, which the cycle amplifies
    by the blocks' conditioning: 1e-5 relative (f32's epsilon is 1.2e-7)."""
    jp, p = cast_builds
    assert type(jp.pc).__name__ == "CastPC"
    pc = to_torch(jp.pc) if source == "converted" else p.pc
    assert type(pc).__name__ == "CastPC"
    assert (pc.out_dtype, pc.in_dtype) == (torch.float64, torch.float32)
    # a move to a device keeps the payload's dtype
    floats = [b.dtype for b in pc.to(torch.device("cpu")).buffers() if b.is_floating_point()]
    assert floats and set(floats) == {torch.float32}
    x = np.random.default_rng(22).normal(size=sum(jp.padded_sizes))
    want = np.asarray(jax.jit(lambda o, v: o(v))(jp.pc, jnp.asarray(x)))
    assert want.dtype == np.float64
    with torch.inference_mode():
        got = pc(torch.from_numpy(x))
    assert got.dtype == torch.float64
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert np.isfinite(got.numpy()).all() and err <= 1e-5, err


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


# -- inner kinds: the same CSR block through porotpu's and the port's builder --

INNER_CASES = {
    "jacobi": dict(method="jacobi"),
    "lu": dict(method="lu"),
    "chebyshev": dict(method="chebyshev", iters=6),
    "cg": dict(method="cg", iters=7),
    "cg+amg": dict(method="cg+amg", iters=5, amg_coarse_size=100),
    # above the dense cap "lu" turns into cg+amg at lu_fallback_iters
    "lu_over_cap": dict(method="lu", lu_max_size=100, lu_fallback_iters=3),
}


@pytest.fixture(scope="module")
def solid_block(builds):
    """porotpu's BC-applied, padded solid preconditioner block with its
    near-nullspace and node coordinates (swelling-3d N=3, 1152 rows)."""
    jp, _ = builds
    _, Pb, _, (bc_dofs, _) = jp._bc_applied_blocks()
    ns, ns_p, dim = jp.ns, jp.ns_p, jp.mesh.dim
    space = jp.W.space("s")
    B = jp._rigid_modes_padded(space, ns, ns_p, 0, bc_dofs)
    xyz = jp._padded_coords(space, (ns_p - ns) // dim)
    return Pb[("s", "s")].tocsr(), dict(dofs_per_node=dim, near_nullspace=B, coords=xyz)


@pytest.mark.parametrize("case", list(INNER_CASES))
def test_inner_kind_matches_porotpu_f64(case, solid_block):
    from porotpu.precond.inner import InnerConfig as JConfig
    from porotpu.precond.inner import build_inner_solver as jbuild
    from porotpu_torch.precond.inner import InnerConfig, build_inner_solver

    A, kw = solid_block
    js = jbuild(A, JConfig(**INNER_CASES[case]), dtype=jnp.float64, **kw)
    ts = build_inner_solver(A, InnerConfig(**INNER_CASES[case]), dtype=torch.float64, **kw)
    assert ts.kind == js.kind and ts.iters == js.iters
    if case == "lu_over_cap":
        assert ts.kind == "cg+amg" and ts.iters == 3
    x = np.random.default_rng(5).normal(size=A.shape[0])
    want = np.asarray(jax.jit(lambda o, v: o(v))(js, jnp.asarray(x)))
    with torch.inference_mode():
        got = ts(torch.from_numpy(x)).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert np.isfinite(got).all() and err <= 1e-12, err


@pytest.mark.parametrize("kind", ["cg", "cg+amg"])
def test_cg_inner_kinds_on_zero_rhs_return_zeros(kind, solid_block):
    from porotpu_torch.precond.inner import InnerConfig, build_inner_solver

    A, kw = solid_block
    ts = build_inner_solver(A, InnerConfig(method=kind, iters=4, amg_coarse_size=100),
                            dtype=torch.float64, **kw)
    with torch.inference_mode():
        y = ts(torch.zeros(A.shape[0], dtype=torch.float64))
    assert torch.equal(y, torch.zeros_like(y))

"""Port parity of the significance workload: corr(x, pvalues=PermutationSpec)
through the replica axis of pcc_tiles (its plain version on the CPU), the
ExceedanceSink and the legacy permutation_pvalues wrapper, against
``repro`` on the CPU.

The port cannot reproduce ``jax.random``, so the parity cases draw the
reference's own index rows here (``jax.random.permutation`` / ``randint``
over ``repro.core.significance.iteration_keys``, vmapped as the reference's
replica_operand draws them) and hand them to the port through
``PermutationSpec(indices=...)``.

Tolerances:
- r within 3e-6 of the reference (bf16 1e-5): the same products summed in
  float32 in different orders;
- p equal at every entry where no replica's float64 value lies within 1e-5
  of the observed float64 value.  A count compares two float32 values;
  where their float64 values are that close, the two packages' different
  summation orders may decide the comparison differently, so p may differ
  there by at most (the number of such near-ties) / (B + 1).  The tests
  count the near-ties and allow exactly those;
- in the port, bitwise: r equals corr(x) without pvalues, p does not
  depend on chunk or on the pass split, p is exactly symmetric, the legacy
  wrapper equals the engine, and replica plain tiles equal the 2-D plain
  tiles of each replica's operand.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import significance as ref_significance
from repro.core.api import corr as ref_corr
from repro.core.plan import ExecutionPlan as RefPlan
from repro.core.significance import PermutationSpec as RefSpec
from repro_torch import convert
from repro_torch.core import measures, significance
from repro_torch.core.api import corr
from repro_torch.core.permutation import permutation_pvalues
from repro_torch.core.plan import ExecutionPlan, pad_operands, pad_scales
from repro_torch.core.quantize import operand_parts, quantize_rows
from repro_torch.core.significance import (PermutationSpec,
                                           dense_significance_reference,
                                           iteration_indices,
                                           pvalue_measure, replica_operand)
from repro_torch.core.sinks import (DenseSink, DeviceTopKSink,
                                    ExceedanceSink, TopKSink)
from repro_torch.kernels.pcc_tile import (MAX_REPLICAS, pcc_tiles,
                                          pcc_tiles_plain)
from repro_torch.launch.mesh import make_mesh

ATOL = 3e-6
BF16_ATOL = 1e-5
TIE = 1e-5          # float64 gap under which a comparison is a near-tie
T, LBLK = 8, 8
N, L, B, CHUNK = 30, 33, 24, 7     # chunks 7, 7, 7, 3: a ragged last chunk


def _x(n, l, seed=0):
    """Normal data scaled by 1/sqrt(l) (covariance and dot stay O(1))."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, l)) / np.sqrt(l)).astype(np.float32)


# -- parity against the reference ---------------------------------------------

# case -> (measure, method, n_cols, l, compute_dtype, max_tiles_per_pass,
#          chunk)
CASES = {
    "pearson": ("pearson", "permute", None, L, None, None, CHUNK),
    "spearman": ("spearman", "permute", None, L, None, None, CHUNK),
    "cosine": ("cosine", "permute", None, L, None, None, CHUNK),
    "covariance": ("covariance", "permute", None, L, None, None, CHUNK),
    "dot": ("dot", "permute", None, L, None, None, CHUNK),
    # re-transform: Kendall's pair expansion (sign-GEMM below l = 96)
    "kendall": ("kendall", "permute", None, 12, None, None, CHUNK),
    "kendall_tau_b": ("kendall_tau_b", "permute", None, 12, None, None,
                      CHUNK),
    "bootstrap": ("pearson", "bootstrap", None, L, None, None, CHUNK),
    "rectangular": ("pearson", "permute", 37, L, None, None, CHUNK),
    "bfloat16": ("pearson", "permute", None, L, "bfloat16", None, CHUNK),
    "int8": ("pearson", "permute", None, L, "int8", None, CHUNK),
    "float8_e4m3fn": ("pearson", "permute", None, L, "float8_e4m3fn", None,
                      CHUNK),
    # 10 tiles in passes of 4, 4, 2; chunks 5, 5, 5, 5, 4
    "multipass": ("pearson", "permute", None, L, None, 4, 5),
}


def _ref_indices(key: int, method: str, l: int) -> np.ndarray:
    """The reference's index rows for RefSpec(B, key, method)."""
    keys = ref_significance.iteration_keys(RefSpec(iterations=B, key=key,
                                                   method=method))
    if method == "bootstrap":
        rows = jax.vmap(lambda k: jax.random.randint(k, (l,), 0, l))(keys)
    else:
        rows = jax.vmap(lambda k: jax.random.permutation(k, l))(keys)
    return np.asarray(rows, dtype=np.int64)


@pytest.fixture(scope="module")
def reference_runs():
    """Lazily computed reference results, one per case (a first reference
    call compiles for a few seconds)."""
    cache = {}

    def get(case):
        if case not in cache:
            measure, method, n_cols, l, cd, mtp, chunk = CASES[case]
            key = 3 + len(cache)
            x = _x(N, l, seed=1)
            y = None if n_cols is None else _x(n_cols, l, seed=2)
            r, p = ref_corr(jnp.asarray(x),
                            None if y is None else jnp.asarray(y),
                            measure=measure, t=T, l_blk=LBLK,
                            max_tiles_per_pass=mtp, compute_dtype=cd,
                            pvalues=RefSpec(iterations=B, key=key,
                                            method=method, chunk=chunk))
            cache[case] = (x, y, _ref_indices(key, method, l), np.asarray(r),
                           np.asarray(p))
        return cache[case]

    return get


def _dequant64(op, n, l):
    """float64 values of a prepared operand's first n rows and l samples."""
    data, scale = operand_parts(op)
    d = data[:n, :l].to(torch.float64)
    return d if scale is None else d * scale[:n, None].to(torch.float64)


def _near_ties(plan, x, y, method, idx):
    """Per output entry, the replicas whose float64 finalised |value| lies
    within TIE of the observed float64 |value|; canonical upper triangle
    mirrored for symmetric runs.  Gather runs work from the prepared
    operand (so quantized operands are held to their own values);
    re-transform runs from a float64 transform of the raw data."""
    meas, l = plan.measure, plan.l
    xt = torch.from_numpy(x)
    yt = xt if y is None else torch.from_numpy(y)
    if method == "permute" and meas.permute_gather:
        ops = (plan.prepare(xt),) if y is None else plan.prepare_pair(xt, yt)
        u = _dequant64(ops[0], x.shape[0], l)
        v = _dequant64(ops[-1], yt.shape[0], l)

        def replica(row):
            return v[:, row]
    else:
        u = meas.transform(xt.double(), dtype=torch.float64)
        v = meas.transform(yt.double(), dtype=torch.float64)

        def replica(row):
            return meas.transform(yt.double()[:, row], dtype=torch.float64)
    obs = meas.finalize(u @ v.T, l).abs()
    ties = torch.zeros(obs.shape, dtype=torch.int64)
    for row in torch.as_tensor(idx):
        rep = meas.finalize(u @ replica(row).T, l).abs()
        ties += (rep - obs).abs() <= TIE
    if y is None:
        ties = torch.where(torch.ones_like(ties, dtype=torch.bool).triu(),
                           ties, ties.T)
    return ties.numpy()


def _assert_p_close(p, p_want, ties, iterations, label=""):
    """p equal where there is no near-tie; elsewhere off by at most the
    near-ties, in counts."""
    d = np.rint(np.abs(np.asarray(p, np.float64)
                       - np.asarray(p_want, np.float64)) * (iterations + 1))
    free = ties == 0
    np.testing.assert_array_equal(np.asarray(p)[free],
                                  np.asarray(p_want)[free], err_msg=label)
    assert np.all(d <= ties), (label, int((d > ties).sum()))
    return int(ties.sum()), int((d > 0).sum())


@pytest.mark.parametrize("case", list(CASES))
def test_corr_pvalues_match_reference(case, reference_runs):
    measure, method, n_cols, l, cd, mtp, chunk = CASES[case]
    x, y, idx, r_ref, p_ref = reference_runs(case)
    spec = PermutationSpec(iterations=B, method=method, chunk=chunk,
                           indices=idx)
    r, p = corr(x, y, measure=measure, t=T, l_blk=LBLK,
                max_tiles_per_pass=mtp, compute_dtype=cd, pvalues=spec,
                device="cpu")
    assert r.shape == p.shape == r_ref.shape and p.dtype == torch.float32
    np.testing.assert_allclose(r.numpy(), r_ref, rtol=0,
                               atol=BF16_ATOL if cd == "bfloat16" else ATOL)
    plan = ExecutionPlan.create(N, l, n_cols=n_cols, measure=measure, t=T,
                                l_blk=LBLK, compute_dtype=cd, replicas=B)
    ties = _near_ties(plan, x, y, method, idx)
    _assert_p_close(p.numpy(), p_ref, ties, B, case)
    if case == "kendall":
        # integer pair counts and one shared reciprocal: exact in both
        # packages, ties included, so nothing may differ
        np.testing.assert_array_equal(p.numpy(), p_ref)
    assert float(p.min()) >= np.float32(1.0) / np.float32(B + 1)
    assert float(p.max()) <= 1.0


def test_port_dense_oracle_matches_the_engine():
    x, y = _x(N, L, seed=4), _x(19, L, seed=5)
    for yy, method in ((None, "permute"), (y, "permute"),
                       (None, "bootstrap")):
        spec = PermutationSpec(iterations=B, key=9, method=method, chunk=5)
        r, p = corr(x, yy, t=T, l_blk=LBLK, pvalues=spec, device="cpu")
        r_o, p_o = dense_significance_reference(
            torch.from_numpy(x), None if yy is None else torch.from_numpy(yy),
            spec=spec)
        np.testing.assert_allclose(r.numpy(), r_o.numpy(), rtol=0, atol=ATOL)
        plan = ExecutionPlan.create(N, L, n_cols=None if yy is None else 19,
                                    t=T, l_blk=LBLK, replicas=B)
        ties = _near_ties(plan, x, yy, method,
                          iteration_indices(spec, L).numpy())
        _assert_p_close(p.numpy(), p_o.numpy(), ties, B, method)


# -- bitwise invariants in the port -------------------------------------------


@pytest.mark.parametrize("measure,cd,fuse,rect", [
    ("pearson", None, True, False), ("pearson", None, True, True),
    ("covariance", None, False, False), ("spearman", None, True, False),
    ("kendall", "int8", True, False), ("pearson", "bfloat16", True, True),
    ("pearson", "int8", True, False), ("cosine", "float8_e5m2", True, True),
])
def test_r_is_bitwise_corr_and_p_symmetric(measure, cd, fuse, rect):
    l = 12 if measure == "kendall" else L
    x = _x(N, l, seed=6)
    y = _x(21, l, seed=7) if rect else None
    kw = dict(measure=measure, compute_dtype=cd, fuse_epilogue=fuse, t=T,
              l_blk=LBLK, max_tiles_per_pass=3, device="cpu")
    r, p = corr(x, y, pvalues=PermutationSpec(iterations=9, key=1, chunk=4),
                **kw)
    assert torch.equal(r, corr(x, y, **kw))
    if not rect:
        assert torch.equal(p, p.T)
        assert torch.all(p.diagonal() == np.float32(1.0) / np.float32(10.0))


@pytest.mark.parametrize("method", ["permute", "bootstrap"])
def test_pvalues_invariant_to_chunk_and_pass_split(method):
    x = _x(N, L, seed=8)
    ps = []
    for chunk in (1, 5, 24, None):
        for mtp in (None, 3):
            _, p = corr(x, t=T, l_blk=LBLK, max_tiles_per_pass=mtp,
                        pvalues=PermutationSpec(iterations=B, key=4,
                                                method=method, chunk=chunk),
                        device="cpu")
            ps.append(p)
    assert all(torch.equal(p, ps[0]) for p in ps)


def test_exactly_iterations_replicas_per_pass(monkeypatch):
    plan = ExecutionPlan.create(N, L, t=T, l_blk=LBLK, replicas=B,
                                replica_chunk=CHUNK, max_tiles_per_pass=4)
    assert plan.replica_chunk_sizes == (7, 7, 7, 3)
    assert plan.launch_sizes == (4, 4, 2)
    calls = []
    real = significance.pcc_tiles

    def spy(u, j0, **kw):
        v = kw.get("v_pad")
        calls.append((j0, kw["pass_tiles"],
                      v.shape[0] if v is not None and v.ndim == 3 else 0))
        return real(u, j0, **kw)

    monkeypatch.setattr(significance, "pcc_tiles", spy)
    corr(_x(N, L, seed=9), t=T, l_blk=LBLK, max_tiles_per_pass=4,
         pvalues=PermutationSpec(iterations=B, key=2, chunk=CHUNK),
         device="cpu")
    want = []
    for k, tiles in enumerate(plan.launch_sizes):
        want += [(4 * k, tiles, 0)] + [(4 * k, tiles, rc)
                                       for rc in plan.replica_chunk_sizes]
    assert calls == want
    assert sum(c[2] for c in calls) == B * plan.n_pass


def test_legacy_wrapper_warns_and_matches_engine_bitwise():
    x = _x(15, 22, seed=10)
    r_w, p_w = permutation_pvalues(x, iterations=20, chunk=7, key=11,
                                   device="cpu")
    r_e, p_e = corr(x, pvalues=PermutationSpec(iterations=20, key=11,
                                               chunk=7), device="cpu")
    assert torch.equal(r_w, r_e) and torch.equal(p_w, p_e)
    with pytest.warns(UserWarning, match="fixed seed 0"):
        r_0, p_0 = permutation_pvalues(x, iterations=6, chunk=4,
                                       device="cpu")
    _, p_k0 = corr(x, pvalues=PermutationSpec(iterations=6, key=0, chunk=4),
                   device="cpu")
    assert torch.equal(p_0, p_k0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        permutation_pvalues(x, iterations=4, chunk=2, key=1, device="cpu")


def _replica_case(dtype, grid, reps):
    """(u, stack, grid_cols, row_scale, col_scale) at a ragged small shape:
    a replica stack of `reps` column operands of type `dtype` ("int8s" is
    scaled int8), triangle (each replica u's shape) or grid."""
    rng = np.random.default_rng(reps)
    t, l_blk = 8, 8
    n, n_cols, l = 37, 21, 29
    rows = n_cols if grid else n

    def make(k, seed):
        z = torch.from_numpy(rng.standard_normal((k, l)).astype(np.float32))
        z = measures.PEARSON.transform(z, dtype=torch.float32)
        if dtype in ("int8s", "float8_e4m3fn", "float8_e5m2"):
            q, s = quantize_rows(z, "int8" if dtype == "int8s" else dtype)
            return pad_operands(q, t, l_blk), pad_scales(s, t)
        if dtype == "int8":
            q = torch.sign(z).to(torch.int8)
            return pad_operands(q, t, l_blk), None
        return pad_operands(z.to(getattr(torch, dtype)), t, l_blk), None

    u, su = make(n, 0)
    cols = [make(rows, s) for s in range(1, reps + 1)]
    stack = torch.stack([c[0].view(torch.uint8) if c[0].element_size() == 1
                         else c[0] for c in cols]).view(u.dtype)
    scol = None if su is None else torch.stack([c[1] for c in cols])
    return u, stack, (stack.shape[1] // t if grid else None), su, scol


@pytest.mark.parametrize("reps", [1, 3, 5])
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int8s",
                                   "float8_e4m3fn", "float8_e5m2"])
def test_replica_plain_tiles_bitwise_2d_plain_tiles(dtype, grid, reps):
    u, stack, gc, su, scol = _replica_case(dtype, grid, reps)
    m = u.shape[0] // 8
    total = m * gc if grid else m * (m + 1) // 2
    for spec in (None, measures.PEARSON.fused_spec(29)):
        kw = dict(t=8, l_blk=8, pass_tiles=total - 3, epilogue=spec,
                  grid_cols=gc, row_scale=su)
        got = pcc_tiles(u, 3, v_pad=stack, col_scale=scol, **kw)
        assert got.shape == (reps, total - 3, 8, 8)
        assert torch.equal(got, pcc_tiles_plain(u, 3, v_pad=stack,
                                                col_scale=scol, **kw))
        for r in range(reps):
            assert torch.equal(got[r], pcc_tiles_plain(
                u, 3, v_pad=stack[r].contiguous(),
                col_scale=None if scol is None else scol[r], **kw))
    if scol is not None:   # one scale vector expanded over the replicas
        one = scol[0].expand(reps, -1)
        got = pcc_tiles(u, 0, t=8, l_blk=8, pass_tiles=total, grid_cols=gc,
                        v_pad=stack, row_scale=su, col_scale=one)
        for r in range(reps):
            assert torch.equal(got[r], pcc_tiles_plain(
                u, 0, t=8, l_blk=8, pass_tiles=total, grid_cols=gc,
                v_pad=stack[r].contiguous(), row_scale=su,
                col_scale=scol[0]))


def test_replica_stacks_are_checked():
    u = torch.zeros(16, 8)
    kw = dict(t=8, l_blk=8, pass_tiles=2)
    with pytest.raises(ValueError, match="matches u_pad exactly"):
        pcc_tiles(u, 0, v_pad=torch.zeros(2, 24, 8), **kw)
    with pytest.raises(ValueError, match="grid_cols"):
        pcc_tiles(u, 0, v_pad=torch.zeros(2, 24, 8), grid_cols=2, **kw)
    with pytest.raises(ValueError, match="replicas"):
        pcc_tiles(u, 0, v_pad=torch.zeros(0, 16, 8), **kw)
    with pytest.raises(ValueError, match="replicas"):
        pcc_tiles(u, 0, v_pad=torch.zeros(MAX_REPLICAS + 1, 16, 8), **kw)
    with pytest.raises(ValueError, match="2-D"):
        pcc_tiles(u, 0, v_pad=torch.zeros(1, 1, 16, 8), **kw)
    q = torch.zeros(16, 8, dtype=torch.int8)
    s = torch.ones(16)
    for bad in (s, torch.ones(3, 16), torch.ones(2, 32)[:, ::2]):
        with pytest.raises(ValueError, match="col_scale"):
            pcc_tiles(q, 0, v_pad=torch.zeros(2, 16, 8, dtype=torch.int8),
                      row_scale=s, col_scale=bad, **kw)


# -- spec, plan and API -------------------------------------------------------


def test_spec_validation_and_required_key():
    with pytest.raises(ValueError, match="explicit key"):
        PermutationSpec(iterations=10)
    with pytest.raises(ValueError, match="iterations"):
        PermutationSpec(iterations=0, key=0)
    with pytest.raises(ValueError, match="method"):
        PermutationSpec(iterations=2, key=0, method="jackknife")
    with pytest.raises(ValueError, match="chunk"):
        PermutationSpec(iterations=2, key=0, chunk=0)
    with pytest.raises(ValueError, match="key"):
        PermutationSpec(iterations=2, key=jnp.zeros(2, jnp.uint32))
    perm = np.stack([np.random.default_rng(i).permutation(5)
                     for i in range(3)])
    ok = PermutationSpec(iterations=3, indices=perm)
    assert torch.equal(iteration_indices(ok, 5), torch.from_numpy(perm))
    for bad, l in ((perm, 6), (perm[:2], 5), (perm.astype(np.float32), 5),
                   (np.zeros((3, 5), np.int64), 5), (perm + 1, 5)):
        with pytest.raises(ValueError, match="indices|permutation"):
            iteration_indices(PermutationSpec(iterations=3, indices=bad),
                              l)
    boot = PermutationSpec(iterations=3, method="bootstrap",
                           indices=np.zeros((3, 5), np.int64))
    assert not iteration_indices(boot, 5).any()


def test_same_seed_same_null_and_names_follow_the_null():
    x = _x(N, L, seed=11)
    plan = ExecutionPlan.create(N, L, t=T, l_blk=LBLK, replicas=B)
    a, b, c = (PermutationSpec(iterations=B, key=k) for k in (5, 5, 6))
    ia, ib, ic = (iteration_indices(s, L) for s in (a, b, c))
    assert torch.equal(ia, ib) and not torch.equal(ia, ic)
    assert all(torch.equal(torch.sort(row).values, torch.arange(L))
               for row in ia)
    na, nb, nc = (pvalue_measure(plan, s, i).name
                  for s, i in ((a, ia), (b, ib), (c, ic)))
    assert na == nb != nc and na.startswith("pearson:pvalues:permute:B24:")
    assert pvalue_measure(plan, PermutationSpec(iterations=B, indices=ia),
                          ia).name == na
    boot = PermutationSpec(iterations=B, key=5, method="bootstrap")
    assert pvalue_measure(plan, boot, iteration_indices(boot, L)).name != na
    gen = torch.Generator().manual_seed(5)
    assert torch.equal(iteration_indices(
        PermutationSpec(iterations=B, key=gen), L), ia)
    _, pa = corr(x, t=T, l_blk=LBLK, pvalues=a, device="cpu")
    _, pb = corr(x, t=T, l_blk=LBLK, pvalues=b, device="cpu")
    assert torch.equal(pa, pb)


def test_planted_pair_gets_the_smallest_p():
    rng = np.random.default_rng(7)
    n, l, b = 16, 80, 200
    base = rng.standard_normal(l).astype(np.float32)
    x = rng.standard_normal((n, l)).astype(np.float32)
    x[0] = base
    x[1] = base + 0.2 * rng.standard_normal(l).astype(np.float32)
    _, p = corr(x, t=T, l_blk=16, pvalues=PermutationSpec(iterations=b,
                                                          key=0),
                device="cpu")
    assert float(p[0, 1]) == np.float32(1.0) / np.float32(b + 1)
    off = p[np.triu_indices(n, k=1)]
    assert float(off.min()) == float(p[0, 1])
    assert bool(((p > 0) & (p <= 1)).all())


def test_spec_dict_and_convert_match_reference_with_replicas():
    for n_cols in (None, 21):
        kw = dict(n_cols=n_cols, t=T, l_blk=LBLK, replicas=B,
                  replica_chunk=CHUNK)
        plan = ExecutionPlan.create(N, L, **kw)
        ref = RefPlan.create(N, L, **kw)
        assert plan.spec_dict() == ref.spec_dict()
        assert plan.spec_dict()["replicas"] == B
        assert plan.replica_chunk_sizes == ref.replica_chunk_sizes
        back = convert.plan_from_reference(ref.spec_dict())
        assert back.replicas == B and back.spec_dict() == ref.spec_dict()
    # Kendall keeps its sign-GEMM at l >= 96 when replicas are asked for
    kp = ExecutionPlan.create(10, 100, measure="kendall", replicas=3)
    kr = RefPlan.create(10, 100, measure="kendall", replicas=3)
    assert kp.spec_dict() == kr.spec_dict()
    assert kp.measure is measures.KENDALL
    # without replicas the same call takes the merge-sort kernel, as in
    # the reference
    mp = ExecutionPlan.create(10, 100, measure="kendall")
    assert mp.measure is measures.KENDALL_MERGE
    assert mp.spec_dict() == RefPlan.create(10, 100,
                                            measure="kendall").spec_dict()
    with pytest.raises(ValueError, match="replicas"):
        ExecutionPlan.create(N, L, replicas=-1)
    with pytest.raises(ValueError, match="replica_chunk"):
        ExecutionPlan.create(N, L, replicas=3, replica_chunk=0)
    assert ExecutionPlan.create(N, L, replicas=200).replica_chunk_sizes == \
        (64, 64, 64, 8)
    assert ExecutionPlan.create(N, L).replica_chunk_sizes == ()


def test_kendall_above_the_merge_crossover_runs_with_pvalues():
    x = _x(10, 100, seed=12)
    spec = PermutationSpec(iterations=3, key=1)
    r, p = corr(x, measure="kendall", t=T, l_blk=512, pvalues=spec,
                device="cpu")
    r_o, p_o = dense_significance_reference(torch.from_numpy(x),
                                            measure="kendall", spec=spec)
    np.testing.assert_allclose(r.numpy(), r_o.numpy(), rtol=0, atol=ATOL)
    assert torch.equal(p, p_o)   # integer counts: no near-ties can move


def test_where_with_pvalues_raises_and_mesh_names_its_slice():
    x = _x(8, 12, seed=13)
    x[0, :3] = np.nan
    spec = PermutationSpec(iterations=4, key=0)
    with pytest.raises(ValueError, match="pvalues= is not supported with "
                                         "where="):
        corr(x, where="nan", pvalues=spec, device="cpu")
    plan = ExecutionPlan.create(8, 12, t=T, l_blk=LBLK, replicas=4)
    u = plan.prepare(torch.from_numpy(np.nan_to_num(x)))
    # ported (slice 18): a mesh is a launch.mesh.Mesh of plan.p ranks, and
    # a mesh run is bitwise the one-device run
    with pytest.raises(TypeError, match="Mesh"):
        significance.run_significance(plan, spec, u, columns=u,
                                      mesh=object())
    mesh = make_mesh((2,), ("d",), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="does not match the mesh"):
        significance.run_significance(plan, spec, u, columns=u, mesh=mesh)
    xs = np.nan_to_num(x)
    r2, p2 = corr(xs, pvalues=spec, mesh=mesh, t=T, l_blk=LBLK,
                  device="cpu")
    r1, p1 = corr(xs, pvalues=spec, t=T, l_blk=LBLK, device="cpu")
    assert torch.equal(r2, r1) and torch.equal(p2, p1)
    with pytest.raises(ValueError, match="replicas"):
        significance.run_significance(
            ExecutionPlan.create(8, 12, t=T, l_blk=LBLK, replicas=5), spec,
            u, columns=u)
    with pytest.raises(ValueError, match="replica"):
        corr(np.nan_to_num(x), pvalues=spec, sink=DeviceTopKSink(3),
             device="cpu")


def test_exceedance_sink_feeds_topk_and_dense_sinks():
    x = _x(20, 24, seed=14)
    spec = dict(iterations=12, key=14, chunk=5)
    _, top = corr(x, t=T, l_blk=LBLK, device="cpu",
                  pvalues=PermutationSpec(**spec, sink=TopKSink(4)))
    _, p = corr(x, t=T, l_blk=LBLK, device="cpu",
                pvalues=PermutationSpec(**spec, sink=DenseSink()))
    p = p.numpy()
    key = np.abs(p)
    np.fill_diagonal(key, -1.0)         # TopKSink excludes self-pairs
    cols = np.broadcast_to(np.arange(20), p.shape)
    want = np.lexsort((cols, -key), axis=1)[:, :4]
    np.testing.assert_array_equal(top["indices"], want)
    np.testing.assert_array_equal(top["values"],
                                  np.take_along_axis(p, want, 1))
    with pytest.raises(ValueError, match="replica count"):
        ExceedanceSink().open(ExecutionPlan.create(20, 24, t=T, l_blk=LBLK),
                              "cpu")


def test_replica_source_seam_and_its_check():
    x = _x(N, L, seed=15)
    spec = PermutationSpec(iterations=B, key=3, chunk=CHUNK)
    _, p = corr(x, t=T, l_blk=LBLK, pvalues=spec, device="cpu")
    plan = ExecutionPlan.create(N, L, t=T, l_blk=LBLK, replicas=B,
                                replica_chunk=CHUNK)
    xt = torch.from_numpy(x)
    u = plan.prepare(xt)
    seen = []

    def source(ci, idx):
        seen.append((ci, idx.shape[0]))
        return replica_operand(plan, idx, method="permute", columns=xt,
                               cols_prepared=u)

    _, p2 = significance.run_significance(plan, spec, u, columns=xt,
                                          replica_source=source)
    assert torch.equal(p, p2) and seen == [(0, 7), (1, 7), (2, 7), (3, 3)]
    qplan = ExecutionPlan.create(N, L, t=T, l_blk=LBLK, replicas=B,
                                 compute_dtype="int8")
    uq = qplan.prepare(xt)
    with pytest.raises(ValueError, match="quantization"):
        significance.run_significance(
            qplan, spec, uq, columns=xt,
            replica_source=lambda ci, idx: torch.zeros(
                (idx.shape[0],) + tuple(uq.shape), dtype=torch.int8))

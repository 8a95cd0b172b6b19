"""Port parity of the main path: repro_torch.corr(x, device="cpu") against
repro.core.api.corr(x), plus the port's own bit-identity invariants, its
plan identity, state conversion, device policy and import hygiene.

Tolerance 3e-6 against the reference: its own Pearson parity bound
(tests/test_distributed.py); both compute in float32 in different orders.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lightpcc as ref_lightpcc
from repro.core.api import corr as ref_corr
from repro.core.pcc import transform as ref_transform
from repro.core.plan import ExecutionPlan as RefPlan
from repro.core.significance import PermutationSpec as RefPermutationSpec
from repro.core.sinks import symmetrize as ref_symmetrize
from repro.data import expression as ref_expression
from repro.kernels.pcc_tile import pcc_tiles as ref_pcc_tiles
from repro_torch import convert
from repro_torch.configs import lightpcc
from repro_torch.core import measures, pcc, sinks
from repro_torch.core.allpairs import allpairs, execute_plan
from repro_torch.core.api import PairwiseProblem, corr
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.significance import PermutationSpec
from repro_torch.data import expression
from repro_torch.kernels.pcc_tile import pcc_tiles
from repro_torch.launch.mesh import make_mesh

ATOL = 3e-6
REPO = Path(__file__).resolve().parents[1]

# (n, l, t, l_blk, max_tiles_per_pass): n never a multiple of t, several
# passes with a ragged last one
CASES = [
    (37, 29, 8, 8, 4),        # 15 tiles = 3 x 4 + 3
    (100, 70, 16, 32, 5),     # 28 tiles = 5 x 5 + 3
    (130, 300, 16, 64, 7),    # 45 tiles = 6 x 7 + 3
]


def _x(n, l, seed=0):
    """Normal data with a zero row and a constant row (exact float32 sums,
    so both packages see zero variance)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, l)).astype(np.float32)
    x[3] = 0.0
    x[n - 2] = 1.5
    return x


@pytest.mark.parametrize("n,l,t,l_blk,mtp", CASES)
def test_corr_matches_reference(n, l, t, l_blk, mtp):
    x = _x(n, l)
    r = corr(x, t=t, l_blk=l_blk, max_tiles_per_pass=mtp, device="cpu")
    want = np.asarray(ref_corr(jnp.asarray(x), t=t, l_blk=l_blk,
                               max_tiles_per_pass=mtp))
    assert r.shape == (n, n) and r.dtype == torch.float32
    np.testing.assert_allclose(r.numpy(), want, rtol=0, atol=ATOL)
    assert torch.equal(r, r.T)
    # degenerate rows score exactly 0 against everything, as in the reference
    for row in (3, n - 2):
        assert not r[row].any() and not np.asarray(want)[row].any()


@pytest.mark.parametrize("n,l,t,l_blk,mtp", CASES)
def test_result_independent_of_pass_split_and_fusion(n, l, t, l_blk, mtp):
    x = _x(n, l, seed=1)
    base = corr(x, t=t, l_blk=l_blk, device="cpu")
    total = -(-n // t) * (-(-n // t) + 1) // 2
    for split in (1, mtp, total - 1, total, 10 * total):
        assert torch.equal(base, corr(x, t=t, l_blk=l_blk, device="cpu",
                                      max_tiles_per_pass=split))
    for split in (None, mtp):
        assert torch.equal(base, corr(x, t=t, l_blk=l_blk, device="cpu",
                                      max_tiles_per_pass=split,
                                      fuse_epilogue=False))


def test_unclipped_run_equals_reference():
    x = _x(37, 29)
    r = corr(x, t=8, l_blk=8, clip=False, device="cpu")
    want = np.asarray(ref_corr(jnp.asarray(x), t=8, l_blk=8, clip=False))
    np.testing.assert_allclose(r.numpy(), want, rtol=0, atol=ATOL)


def test_allpairs_and_tensor_input_equal_corr():
    x = _x(37, 29)
    r = corr(x, t=8, l_blk=8, device="cpu")
    assert torch.equal(r, allpairs(x, t=8, l_blk=8, device="cpu"))
    assert torch.equal(r, corr(torch.from_numpy(x), t=8, l_blk=8,
                               device="cpu"))


@pytest.mark.parametrize("kw", [
    dict(), dict(t=16, l_blk=8), dict(max_tiles_per_pass=5),
    dict(max_tiles_per_pass=10 ** 6), dict(clip=False),
    dict(fuse_epilogue=False), dict(t=8, l_blk=64, max_tiles_per_pass=7),
])
def test_spec_dict_equals_reference(kw):
    for n, l in [(37, 29), (17_555, 5_072)]:
        ours = ExecutionPlan.create(n, l, **kw)
        ref = RefPlan.create(n, l, **kw)
        assert ours.spec_dict() == ref.spec_dict()
        assert ours.spec_key() == ref.spec_key()
        assert ours.launch_sizes == ref.launch_sizes
        assert [ours.pass_offset(k) for k in range(ours.n_pass)] == \
            [ref.pass_offset(k) for k in range(ref.n_pass)]


def test_plan_rejects_bad_arguments():
    with pytest.raises(ValueError):
        ExecutionPlan.create(10, 10, max_tiles_per_pass=0)
    with pytest.raises(ValueError):
        ExecutionPlan.create(10, 10, l_blk=0)
    with pytest.raises(ValueError):
        ExecutionPlan.create(10, 10).prepare(torch.zeros(9, 10))


def test_convert_reproduces_reference_tiles_and_result():
    n, l, t, l_blk, mtp = 100, 70, 16, 32, 5
    x = _x(n, l, seed=2)
    ref_plan = RefPlan.create(n, l, t=t, l_blk=l_blk, max_tiles_per_pass=mtp)
    ref_u = ref_plan.prepare(jnp.asarray(x))
    plan = convert.plan_from_reference(ref_plan.spec_dict())
    u = convert.operand_from_reference(np.asarray(ref_u), device="cpu")
    assert plan.spec_dict() == ref_plan.spec_dict()
    for k, launch in enumerate(plan.launch_sizes):
        j0 = plan.pass_offset(k)
        got = pcc_tiles(u, j0, t=t, l_blk=l_blk, pass_tiles=launch,
                        epilogue=plan.epilogue_spec)
        want = ref_pcc_tiles(ref_u, j0, t=t, l_blk=l_blk, pass_tiles=launch,
                             interpret=True, epilogue=ref_plan.epilogue_spec)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    r = execute_plan(plan, u, device="cpu")
    np.testing.assert_allclose(
        r.numpy(), np.asarray(ref_corr(jnp.asarray(x), t=t, l_blk=l_blk,
                                       max_tiles_per_pass=mtp)),
        rtol=0, atol=ATOL)


def test_convert_refuses_modes_of_later_slices():
    spec = RefPlan.create(37, 29, t=8, l_blk=8).spec_dict()
    # fp8 operands are ported: the spec converts, key for key
    fp8 = {**spec, "compute_dtype": "float8_e4m3fn"}
    plan = convert.plan_from_reference(fp8)
    assert plan.spec_dict() == fp8 and plan.scaled
    # significance plans are ported: the replica count converts too
    sig = RefPlan.create(37, 29, t=8, l_blk=8, replicas=8).spec_dict()
    plan = convert.plan_from_reference(sig)
    assert plan.spec_dict() == sig and plan.replicas == 8
    for key, value in [("compute_dtype", "float16"), ("p", 4),
                       ("symmetric_grid", True)]:
        if (key, value) == ("compute_dtype", "float16"):
            # float16 operands are ported: the spec converts, key for key
            f16 = {**spec, key: value}
            plan = convert.plan_from_reference(f16)
            assert plan.spec_dict() == f16
            assert plan.compute_dtype == torch.float16
            continue
        with pytest.raises(NotImplementedError):
            convert.plan_from_reference({**spec, key: value})
    with pytest.raises(ValueError):
        convert.plan_from_reference({**spec, "replicas": -1})
    with pytest.raises(ValueError):
        convert.plan_from_reference({**spec, "total_tiles": 1})
    with pytest.raises(ValueError):
        convert.operand_from_reference(np.zeros((8, 8)), device="cpu")


def test_execute_plan_validates_operand():
    plan = ExecutionPlan.create(37, 29, t=8, l_blk=8)
    with pytest.raises(ValueError):
        execute_plan(plan, torch.zeros(40, 8), device="cpu")


def test_transform_matches_reference_and_zeroes_degenerate_rows():
    x = _x(50, 40, seed=3)
    u = pcc.transform(torch.from_numpy(x))
    want = np.asarray(ref_transform(jnp.asarray(x)))
    np.testing.assert_allclose(u.numpy(), want, rtol=0, atol=1e-7)
    assert not u[3].any() and not u[48].any()
    r = pcc.pearson_gemm(torch.from_numpy(x)).numpy()
    lit = pcc.pearson_literal(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(r, lit, rtol=0, atol=ATOL)
    with pytest.raises(ValueError):
        pcc.transform(torch.zeros(3))


def test_symmetrize_and_scatter_bitwise_equal_reference(monkeypatch):
    monkeypatch.setattr(sinks, "_BAND", 8)   # several bands at a small n
    rng = np.random.default_rng(4)
    r_pad = rng.standard_normal((40, 40)).astype(np.float32)
    want = np.asarray(ref_symmetrize(jnp.asarray(r_pad), 37))
    got = sinks.symmetrize(torch.from_numpy(r_pad.copy()), 37)
    np.testing.assert_array_equal(got.numpy(), want)
    tiles = torch.from_numpy(rng.standard_normal((3, 8, 8)).astype(np.float32))
    out = sinks.scatter_tiles_at(torch.zeros(40, 40), tiles,
                                 np.array([0, 1, 4]), np.array([2, 1, 4]), 8)
    assert torch.equal(out[0:8, 16:24], tiles[0])
    assert torch.equal(out[8:16, 8:16], tiles[1])
    assert torch.equal(out[32:40, 32:40], tiles[2])
    assert int((out != 0).sum()) == 3 * 64


def test_configs_and_data_equal_reference():
    for name in ("ARTIFICIAL_16K", "ARTIFICIAL_32K", "ARTIFICIAL_64K",
                 "REAL_SEEK"):
        ours, ref = getattr(lightpcc, name), getattr(ref_lightpcc, name)
        assert (ours.name, ours.n, ours.l, ours.t, ours.l_blk) == \
            (ref.name, ref.n, ref.l, ref.t, ref.l_blk)
        assert lightpcc.flops(ours) == ref_lightpcc.flops(ref)
    ours = expression.artificial(expression.ExpressionSpec(n=31, l=17, seed=5))
    ref = ref_expression.artificial(
        ref_expression.ExpressionSpec(n=31, l=17, seed=5))
    assert ours.dtype == np.float32 and ours.tobytes() == ref.tobytes()


def test_corr_without_device_raises_on_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        corr(_x(37, 29))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.operand_from_reference(np.zeros((8, 8), np.float32))


@pytest.mark.parametrize("kw", [
    dict(where="nan"),
    dict(mesh=object()), dict(shard_u=True),
    dict(compute_dtype="float8_e4m3fn"),
    dict(resume_from="r.mm"), dict(pvalues=3), dict(recovery=object()),
])
def test_unported_corr_options_name_their_slice(kw):
    x = _x(37, 29)
    if "pvalues" in kw:
        # ported (slice 8): a significance run's r matches the reference's
        got, _ = corr(x, t=8, l_blk=8, device="cpu", pvalues=PermutationSpec(
            iterations=kw["pvalues"], key=0))
        want, _ = ref_corr(jnp.asarray(x), t=8, l_blk=8,
                           pvalues=RefPermutationSpec(
                               iterations=kw["pvalues"], key=0))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
        return
    if "resume_from" in kw:
        # ported (slice 4): both packages refuse a path with no checkpoint
        for run in (lambda: corr(x, device="cpu", **kw),
                    lambda: ref_corr(jnp.asarray(x), **kw)):
            with pytest.raises(ValueError, match="sidecar unreadable"):
                run()
        return
    if "recovery" in kw:
        # ported (slice 10): a recovering run under the same transient
        # fault fires it in both packages and matches the reference
        from repro.runtime import faults as ref_faults
        from repro_torch.runtime import faults
        kw3 = dict(t=8, l_blk=8, max_tiles_per_pass=4)
        want_fp = ref_faults.FaultPlan.single("pass_launch", "transient",
                                              at=2)
        with want_fp.armed():
            want = ref_corr(jnp.asarray(x), recovery=ref_faults.RetryPolicy(
                sleep=lambda s: None), **kw3)
        got_fp = faults.FaultPlan.single("pass_launch", "transient", at=2)
        with got_fp.armed():
            got = corr(x, device="cpu", recovery=faults.RetryPolicy(
                sleep=lambda s: None), **kw3)
        assert got_fp.fired == want_fp.fired == [
            ("pass_launch", 2, "transient")]
        assert torch.equal(got, corr(x, device="cpu", **kw3))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
        return
    if set(kw) <= {"where", "compute_dtype"}:
        # ported: masked runs (slice 5) and fp8 operands (slice 6) match
        # the reference
        got = corr(x, t=8, l_blk=8, max_tiles_per_pass=4, device="cpu", **kw)
        want = ref_corr(jnp.asarray(x), t=8, l_blk=8, max_tiles_per_pass=4,
                        **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
        return
    kw3 = dict(t=8, l_blk=8, max_tiles_per_pass=4, device="cpu")
    alone = corr(x, **kw3)
    if "mesh" in kw:
        # ported (slice 18): a mesh is a launch.mesh.Mesh, anything else is
        # refused; a 4-rank mesh gives the one-device bits and the
        # reference's values
        with pytest.raises(TypeError, match="Mesh"):
            corr(x, device="cpu", **kw)
        mesh = make_mesh((4,), ("d",), devices=["cpu"] * 4)
        got = corr(x, mesh=mesh, **kw3)
        want = ref_corr(jnp.asarray(x), t=8, l_blk=8)
    else:
        # ported (slice 18): shard_u without a mesh changes nothing, as in
        # the reference
        got = corr(x, **kw3, **kw)
        want = ref_corr(jnp.asarray(x), t=8, l_blk=8, **kw)
    assert torch.equal(got, alone)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_measures_of_later_slices_raise():
    assert measures.get("pcc") is measures.PEARSON
    v = torch.tensor([-1.5, -0.25, 0.0, 0.75, 2.0])
    spec = measures.PEARSON.fused_spec(29)
    assert torch.equal(measures.PEARSON.finalize(v, 29), spec.apply(v))
    assert torch.equal(measures.PEARSON.finalize(v, 29, clip=False), v)
    assert measures.resolve_fusion(measures.PEARSON, False, 29) == (None,
                                                                     False)
    assert PairwiseProblem.create(_x(4, 3), device="cpu").symmetric
    # merge-sort Kendall (slice 7) is ported: bitwise the reference's
    np.testing.assert_array_equal(
        corr(_x(37, 29), measure="kendall_merge", t=8, l_blk=8,
             device="cpu").numpy(),
        np.asarray(ref_corr(jnp.asarray(_x(37, 29)), measure="kendall_merge",
                            t=8, l_blk=8)))
    with pytest.raises(ValueError):
        measures.get("nope")
    with pytest.raises(ValueError):
        PairwiseProblem.create(np.zeros(3, np.float32), device="cpu")


def _port_sources():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_repro():
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), \
                    f"{path.relative_to(REPO)} imports {name}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.core.api, repro_torch.convert, "
            "repro_torch.models.registry, repro_torch.configs, "
            "repro_torch.launch.serve, "
            "repro_torch.configs.qwen3_moe_30b_a3b, "
            "repro_torch.configs.mixtral_8x22b; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)

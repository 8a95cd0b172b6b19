"""The roofline (launch/roofline.py), its experiments (launch/hillclimb.py)
and the tables (launch/report.py) against the reference's.

The reference's roofline and hillclimb set XLA_FLAGS when imported, so
their analysis transforms run in a subprocess here and come back as each
transformed config's fields; ``repro.launch.report`` is safe to import and
prints its tables of the port's records.  The counts run the dry run over
(2, 2) meta ranks on SMOKE configs at a few rows (llama3.2-3b SMOKE at 6
layers, so that the L = 2, 4 fit is extrapolated, not a direct count).
"""

import dataclasses
import inspect
import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.launch import report as ref_report
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import dryrun, hillclimb, report, roofline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import config
from repro_torch.models.registry import build_model

SMALL = {"train_4k": (64, 8, "train"), "prefill_32k": (128, 4, "prefill"),
         "decode_32k": (128, 8, "decode")}


def test_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9
    src = inspect.getsource(roofline)
    assert "H100 80GB HBM3 SXM" in src and "700 W" in src
    for v5e in (r"\b197e12", r"\b819e9", r"\b50e9", "v5e"):
        assert not re.search(v5e, src), v5e


def test_fit_is_affine():
    assert roofline._fit(2, 10.0, 4, 16.0, 28) == 10.0 + 3.0 * 26


_TRANSFORMS = textwrap.dedent("""
    import dataclasses, json
    from repro.configs import get_config, list_archs
    from repro.launch import hillclimb, roofline
    out = {"analysis": {}, "experiments": {}}
    for arch in list_archs():
        for n in (2, 4, 8, None):
            cfg = roofline._analysis_transform(n)(get_config(arch))
            out["analysis"][f"{arch}/{n}"] = dataclasses.asdict(cfg)
    for name, (arch, shape, tag, tf) in hillclimb.EXPERIMENTS.items():
        out["experiments"][name] = [arch, shape, tag,
                                    dataclasses.asdict(tf(get_config(arch)))]
    print("JSON" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_transforms():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.path.join(root, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _TRANSFORMS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("JSON")][-1]
    return json.loads(line[4:])


def _fields(cfg) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def test_analysis_transform_is_the_references(reference_transforms):
    """The same analysis variant of every FULL config at L = 2, 4, 8 and
    full depth: unrolled, one micro-batch, chunks coarsened 4x (capped),
    hymba's global layers {0, L / 2, L - 1}."""
    for arch in list_archs():
        for n in (2, 4, 8, None):
            got = _fields(roofline._analysis_transform(n)(get_config(arch)))
            assert got == reference_transforms["analysis"][f"{arch}/{n}"], \
                (arch, n)


def test_hillclimb_experiments_are_the_references(reference_transforms):
    want = reference_transforms["experiments"]
    assert list(hillclimb.EXPERIMENTS) == list(want)
    for name, (arch, shape, tag, tf) in hillclimb.EXPERIMENTS.items():
        assert [arch, shape, tag, _fields(tf(get_config(arch)))] == \
            want[name], name


@pytest.fixture
def small(monkeypatch):
    """The dry run over (2, 2) meta ranks, SMOKE configs at SMALL shapes,
    llama3.2-3b SMOKE at 6 layers; records into temporary directories."""
    def smoke(arch):
        cfg = get_config(arch, smoke=True)
        if arch == "llama3.2-3b":
            cfg = dataclasses.replace(cfg, n_layers=6)
        return cfg
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: make_mesh(
                            (2, 2), ("data", "model"),
                            devices=["meta"] * 4))
    monkeypatch.setattr(dryrun, "get_config", smoke)
    monkeypatch.setattr(roofline, "get_config", smoke)
    for k, v in SMALL.items():
        monkeypatch.setitem(config.SHAPES, k, v)


def test_validate_fit_holds_within_one_percent(small):
    """The affine fit at L = 2, 4 against the direct count at 6 layers:
    the layers are alike, so the FLOPs are affine in L."""
    out = roofline.validate_fit("llama3.2-3b", "train_4k")
    assert out["rel_err"] < 0.01
    fit, direct = out["fit"], out["direct"]
    assert fit["method"] == "affine-fit(L=2,4)"
    assert direct["method"] == "direct-unroll"
    assert abs(fit["coll_bytes_per_chip"] - direct["coll_bytes_per_chip"]) \
        <= 0.01 * direct["coll_bytes_per_chip"]


def test_roofline_record_has_the_references_keys(small):
    rec = roofline.analyze_cell("llama3.2-3b", "prefill_32k", save=False)
    assert set(rec) == {
        "label", "arch", "shape", "kind", "chips", "method",
        "hlo_flops_per_chip", "hlo_bytes_per_chip", "coll_bytes_per_chip",
        "coll_by_kind", "terms_s", "bottleneck", "model_flops_global",
        "model_flops_per_chip", "useful_fraction", "model_vs_hlo_flops",
        "redundant_collectives", "compiles"}
    seq, batch, _ = SMALL["prefill_32k"]
    n_active = build_model(roofline.get_config(
        "llama3.2-3b")).active_param_count()
    assert rec["model_flops_global"] == 2 * n_active * seq * batch
    t = rec["terms_s"]
    assert t["compute_s"] == rec["hlo_flops_per_chip"] / 989e12
    assert t["memory_s"] == rec["hlo_bytes_per_chip"] / 3.35e12
    assert t["collective_s"] == rec["coll_bytes_per_chip"] / 450e9


def test_report_tables_are_the_references(small, tmp_path, monkeypatch):
    """The port's tables of the port's records are text-equal to the
    reference's report of the same records."""
    dry, roof = tmp_path / "dryrun", tmp_path / "roofline"
    dry.mkdir()
    roof.mkdir()
    for arch, shape in (("llama3.2-3b", "train_4k"),
                        ("qwen3-moe-30b-a3b", "decode_32k")):
        rec = dryrun.run_cell(arch, shape, False, save=False)
        (dry / f"{rec['label']}.json").write_text(json.dumps(rec))
    for arch, shape, tag in (("llama3.2-3b", "prefill_32k", ""),
                             ("hymba-1.5b", "decode_32k", ""),
                             ("llama3.2-3b", "prefill_32k", "cs")):
        rec = roofline.analyze_cell(arch, shape, save=False, tag=tag)
        (roof / f"{rec['label']}.json").write_text(json.dumps(rec))
    for mod in (report, ref_report):
        monkeypatch.setattr(mod, "DRYRUN_DIR", str(dry))
        monkeypatch.setattr(mod, "ROOF_DIR", str(roof))
    assert report.dryrun_table() == ref_report.dryrun_table()
    assert report.roofline_table() == ref_report.roofline_table()
    assert report.collective_breakdown() == ref_report.collective_breakdown()
    assert report.dryrun_table().count("\n") == 3
    assert report.roofline_table().count("\n") == 3   # the tagged one left out
    assert np.isfinite(json.loads((roof / "llama3.2-3b__prefill_32k__pod1"
                                   ".json").read_text())["useful_fraction"])

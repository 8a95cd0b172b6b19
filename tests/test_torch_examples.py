"""The port's examples (examples/torch_*.py) run end to end on the CPU, each
at its default small size in its own process, and keep their reference's
assertions (module-recovery precision > 0.9, the planted pair the most
significant, served answers bitwise standalone corr(), standing results
matching a cold corr(), a decoded batch of the expected shape, a falling
training loss).  Without ``--device cpu`` each one asks for the card."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(*args):
    # one intra-op thread: the examples are small, and the suite's other
    # workers share the cores
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script,extra,expect", [
    ("torch_quickstart.py", [], "raw stream bitwise: True"),
    ("torch_coexpression_network.py", [], "OK — co-expression network"),
    ("torch_coexpression_network.py", ["--topk", "10"],
     "module recovery (kNN)"),
    # merge-sort Kendall (l = 200 >= 96), tau-a thresholded and tau-b kNN
    ("torch_coexpression_network.py",
     ["--measure", "kendall", "--threshold", "0.3"],
     "OK — co-expression network"),
    ("torch_coexpression_network.py",
     ["--measure", "kendall_tau_b", "--topk", "10"], "module recovery (kNN)"),
    ("torch_permutation_test.py", [], "OK"),
    ("torch_corr_server.py", [], "OK — served answers bit-identical"),
    ("torch_live_index.py", [], "OK — all standing results matched"),
    # the LM side: hymba-1.5b's smoke config, prefill + greedy decode
    ("torch_serve_lm.py", [],
     "arch=hymba-1.5b-smoke batch=4 prefill(48 tok)="),
    # the VLM (embeddings, m-rope streams) and the encoder-decoder
    ("torch_serve_lm.py", ["--arch", "qwen2-vl-72b"],
     "arch=qwen2-vl-72b-smoke batch=4 prefill(48 tok)="),
    ("torch_serve_lm.py", ["--arch", "seamless-m4t-medium"],
     "arch=seamless-m4t-medium-smoke batch=4 prefill(48 tok)="),
])
def test_example_runs_on_cpu(script, extra, expect):
    out = _run(f"examples/{script}", "--device", "cpu", *extra)
    assert out.returncode == 0, out.stderr[-2000:]
    assert expect in out.stdout


def test_train_example_runs_on_cpu(tmp_path):
    """examples/torch_train_lm.py at its tiny preset, a few steps: the
    loss falls (the example asserts it)."""
    out = _run("examples/torch_train_lm.py", "--device", "cpu", "--steps",
               "30", "--seq", "64", "--ckpt-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "steps=30 loss" in out.stdout and "OK" in out.stdout
    assert os.listdir(tmp_path)      # it checkpointed (step 0)


def test_examples_import_no_jax():
    for path in sorted((ROOT / "examples").glob("torch_*.py")):
        src = path.read_text()
        assert "import jax" not in src and "from repro." not in src \
            and "import repro\n" not in src, path.name

"""The LM slice end to end on the CPU, dense family: the port's prefill and
greedy decode against the reference's jitted steps (tests/_lm_parity.py,
which states the tolerances) for the SMOKE configs of llama3.2-3b,
starcoder2-3b (gelu, qkv bias), chatglm3-6b (half RoPE, untied head) and
nemotron-4-340b (squared ReLU)."""

import pytest

from _lm_parity import check_decode, check_prefill

CASES = [("llama3.2-3b", None), ("starcoder2-3b", None),
         ("chatglm3-6b", None), ("nemotron-4-340b", None)]


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_logits_and_caches(arch, dtype):
    check_prefill(arch, dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_greedy_decode_steps(arch, dtype):
    check_decode(arch, dtype)

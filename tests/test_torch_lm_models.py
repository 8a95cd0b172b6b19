"""The LM slice end to end on the CPU, hybrid and SSM families: the port's
prefill and greedy decode against the reference's jitted steps
(tests/_lm_parity.py, which states the tolerances) for the SMOKE configs of
hymba-1.5b (float32 and bf16) and falcon-mamba-7b."""

import pytest

from _lm_parity import check_decode, check_prefill

CASES = [("hymba-1.5b", None), ("hymba-1.5b", "bfloat16"),
         ("falcon-mamba-7b", None)]


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_logits_and_caches(arch, dtype):
    check_prefill(arch, dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_greedy_decode_steps(arch, dtype):
    check_decode(arch, dtype)

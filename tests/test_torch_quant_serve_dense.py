"""int8 serving (W8A16 and W8A8) of deepseek-67b, minitron-8b and
internvl2-76b (text only), the dense family: the tests of
tests/test_torch_quant_serve.py, on these archs' smoke configs against
the JAX package.
"""

import pytest

from tests.test_torch_quant_serve import (  # noqa: F401  (the same tests)
    dense_runs, make_smoke, mode,
    test_int8_continuous_batch_equals_solo_greedy,
    test_int8_engine_tokens_match_jax_engine,
    test_int8_prefill_and_decode_logits_match_jax)


@pytest.fixture(scope="module", params=["deepseek-67b", "minitron-8b",
                                               "internvl2-76b"])
def smoke(request):
    return make_smoke(request.param)

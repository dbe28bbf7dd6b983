"""``tests/test_torch_train.py``'s loss, gradient and three-step parity
tests on the MoE, Mamba-2 and Zamba2 smoke configs: kimi-k2's MoE FFN,
mamba2's SSD blocks, zamba2's Mamba blocks around its shared attention
block, and grok-1's MoE under the Adafactor its full config names.  The
tolerances are that file's (zamba2's wider ones and Adafactor's unchosen
router rows are explained there)."""

import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as j_smoke_config  # noqa: E402

from test_torch_train import (  # noqa: E402,F401  (collected here with this file's cases)
    make_case,
    test_loss_and_grads_match_jax,
    test_three_train_steps_match_jax,
)

JCFGS = {"kimi-smoke": j_smoke_config("kimi-k2-1t-a32b"),
         "mamba2-smoke": j_smoke_config("mamba2-2.7b"),
         "zamba2-smoke": j_smoke_config("zamba2-7b"),
         "grok-smoke-adafactor": j_smoke_config("grok-1-314b").replace(optimizer="adafactor")}


@pytest.fixture(scope="module", params=sorted(JCFGS))
def case(request):
    return make_case(request.param, JCFGS[request.param])

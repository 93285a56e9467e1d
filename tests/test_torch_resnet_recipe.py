"""Config #2's recipe (``bench.py``'s ResNet step, ``sgd(0.1,
momentum=0.9)``) on one fixed batch for 21 steps, in the port and in the
JAX package, on the CPU (``resnet18_ish``, 1000 classes, 8 x 16^2, bf16):
the loss climbs before it falls on both sides, so ``chip_smoke.py`` holds
the card's 21 losses to falling below half their peak, not below their
start. The rest of the ResNet parity tests are in
``tests/test_torch_resnet.py``, whose helpers this file shares.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import resnet as jr
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import resnet as tr
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.optimizer import sgd
from test_torch_resnet import _fresh_port_state, _jax_sgd_steps  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this module's CPU-bound steps, restored
    after it: the suite runs several test workers on one machine, and a
    worker whose every op spreads over all the cores slows the others
    several times over. The bar here (a loss that climbs, then falls
    below half its peak) does not hang on the order of a few CPU sums."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_fixed_batch_loss_climbs_then_falls():
    """21 bf16 steps of ``sgd(0.1, momentum=0.9)`` on one fixed batch of
    ``default_rng(0)`` pixels and labels, the first as in ``chip_smoke.py``
    ``phase_resnet``: both sides' loss more than doubles, then ends below
    half its peak."""
    jc = jr.ResNetConfig.resnet18_ish(num_classes=1000)
    tc = tr.ResNetConfig.resnet18_ish(num_classes=1000)
    start = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.bfloat16), np.float32),
                                   jr.init_resnet(jc, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, jc.num_classes, (8,))
    _, jlosses = _jax_sgd_steps(
        jc, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), start),
        {"pixels": jnp.asarray(x, jnp.bfloat16), "labels": jnp.asarray(labels, jnp.int32)}, 21)
    acc = Accelerator(cpu=True)
    tparams, opt = acc.prepare(params_from_numpy(start, device="cpu", dtype=torch.bfloat16),
                               sgd(0.1, momentum=0.9))
    step = acc.prepare_train_step(lambda p, b: tr.resnet_loss(p, b, tc), opt)
    tbatch = {"pixels": torch.from_numpy(x).to(torch.bfloat16), "labels": torch.from_numpy(labels)}
    state, tlosses = opt.opt_state, []
    for _ in range(21):
        tparams, state, m = step(tparams, state, tbatch)
        tlosses.append(float(m["loss"]))
    for losses in (jlosses, np.array(tlosses)):
        assert np.isfinite(losses).all()
        assert losses.max() > 2 * losses[0] and losses[-1] < 0.5 * losses.max(), losses

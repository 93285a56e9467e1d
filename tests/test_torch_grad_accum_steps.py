"""Gradient accumulation and the fp16 default scaler of the port against
the JAX package's, on the CPU (split from ``tests/test_torch_grad_accum.py``,
whose docstring gives the setup, the tolerances and their measurements,
and whose helpers and bars this file shares):

- gradient accumulation (``optax.MultiSteps``) through ``prepare_train_step``
  against the JAX ``prepare_train_loop`` with ``gradient_accumulation_steps=4``
  on bert-tiny + fused attention, in f32 and bf16;
- ``mixed_precision="fp16"`` with the default dynamic loss scaler, with and
  without accumulation, against the JAX fp16 step.
"""

import jax
import numpy as np
import pytest
import torch

from accelerate_tpu_torch import bert_loss
from accelerate_tpu_torch.optimizer import adamw, param_leaves
from test_torch_grad_accum import (  # noqa: F401
    ACCUM,
    LOSS_RTOL,
    LR,
    MICRO,
    _bert,
    _check_updates,
    _fp16_run,
    _fresh_port_state,
    _two_torch_threads,
    _jax_loop,
    _named,
    _port_acc,
)


@pytest.mark.parametrize("precision", ["no", "bf16"])
def test_accumulation_matches_the_jax_loop(precision):
    """12 micro-steps at accumulation 4, one ``prepare_train_step`` call
    each: per-micro-step losses, 3 optimizer steps, params bitwise unchanged
    between boundaries, and the 12-step updates against the JAX loop."""
    jcfg, tcfg, jparams, batches = _bert()
    init = dict(_named(jax.tree_util.tree_map(np.asarray, jparams)))
    acc = _port_acc(precision, ACCUM)
    assert acc.gradient_accumulation_steps == ACCUM
    params, opt = acc.prepare(jax.tree_util.tree_map(np.asarray, jparams), adamw(LR))
    assert opt.accumulation_steps == ACCUM
    step = acc.prepare_train_step(lambda p, b: bert_loss(p, b, tcfg), opt)
    losses, boundaries = [], []
    for i, batch in enumerate(batches):
        before = [t.detach().clone() for t in param_leaves(params)]
        params, _, m = step(params, opt.opt_state, batch)
        losses.append(float(m["loss"]))
        same = all(torch.equal(a, b) for a, b in zip(before, param_leaves(params)))
        boundaries.append(not same)
        assert opt.is_accumulation_boundary == (i % ACCUM == ACCUM - 1)
    assert boundaries == [i % ACCUM == ACCUM - 1 for i in range(MICRO)]
    assert opt.step_count == MICRO // ACCUM and opt.mini_step == 0
    assert float(opt.acc_grads.abs().max()) == 0.0  # the buffer is back to 0

    np_batches = [{k: v.numpy() for k, v in b.items()} for b in batches]
    j_metrics, j_flat = _jax_loop(jparams, np_batches, jcfg, precision, ACCUM)
    np.testing.assert_allclose(losses, j_metrics["loss"], rtol=LOSS_RTOL[precision])
    _check_updates(params, j_flat, init, precision, MICRO // ACCUM)


@pytest.mark.parametrize("accum", [1, ACCUM])
def test_fp16_default_scaler_matches_the_jax_step(accum):
    m = _fp16_run(accum, None)
    assert m["grads_finite"].all() and (m["loss_scale"] == 2.0 ** 15).all()

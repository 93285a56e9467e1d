"""``llama_forward``'s ``remat`` policies, and bf16 params with adafactor
through ``prepare_train_loop``, against the JAX package on the CPU at
``LlamaConfig.tiny()`` (2 layers, dim 128, 4 heads over 2 kv heads).

- ``llama_loss`` gradients at each policy against JAX's at the same policy
  (f32, the einsum path, and one packed case through JAX's interpreted
  flash kernels), held as ``tests/test_torch_llama_train.py`` holds them:
  losses within 1e-5 relative, gradients within 1e-4 of each leaf's largest
  magnitude (the sides differ in the order of f32 sums);
- the port's gradients at each policy equal its no-remat gradients
  bitwise: recomputing an op on the CPU gives the same bits (on one
  thread: the embedding's backward adds repeated tokens' rows in a
  thread-dependent order, so even two no-remat runs differ in its last
  bit on several);
- what each policy recomputes, counted at the dispatcher during backward;
- ``"offload_dots"``: gradients bitwise equal to ``"dots_no_batch"``'s, the
  same dispatcher counts, and the saved projections held in host memory
  (not in the checkpoint's own cache) between the forward and the
  backward;
- the unknown-name error;
- 3 steps of ``prepare_train_loop`` with bf16 params and ``adafactor``
  against the JAX ``Accelerator``, under ``mixed_precision`` "no" and
  "bf16", within the envelope written at that test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models import transformer as jt
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.utils.operations import stack_batches as jstack
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import transformer as tt
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.optimizer import Adafactor, adafactor, adamw, param_leaves
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils import packing as tpacking
from accelerate_tpu_torch.utils.operations import stack_batches

JCFG = jt.LlamaConfig.tiny()
TCFG = tt.LlamaConfig.tiny()
B, S = 2, 128
POLICIES = [True, "nothing", "dots", "dots_no_batch", "offload_dots"]


@pytest.fixture(scope="module")
def params():
    jp = jt.init_llama(JCFG, jax.random.PRNGKey(0))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _ids(seed, rows=B, seq=S):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, (rows, seq)).astype(np.int32)


def _packed(seed):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, JCFG.vocab_size, n) for n in rng.integers(S // 8, S // 2, 6 * B)]
    ids, seg = tpacking.pack_sequences(docs, S)
    return ids[:B], seg[:B]


def _port_grads(np_params, batch, **kw):
    tp = params_from_numpy(np_params, device="cpu")
    leaves = param_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss = tt.llama_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, TCFG, **kw)
    loss.backward()
    return loss.detach(), [t.grad for t in leaves]


CASES = [(p, "xla", False) for p in POLICIES] + [("dots_no_batch", "flash", True)]


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("remat,impl,packed", CASES,
                         ids=[f"{p}-{i}{'-packed' if k else ''}" for p, i, k in CASES])
def test_remat_grads_match_jax_and_equal_no_remat(params, remat, impl, packed, monkeypatch,
                                                 one_thread):
    jp, np_params = params
    ids, seg = _packed(3) if packed else (_ids(3), None)
    batch = {"input_ids": ids} if seg is None else {"input_ids": ids, "segment_ids": seg}
    monkeypatch.setenv("ACCELERATE_FLASH_KERNEL", "interpret")  # JAX's flash kernels
    j_loss, j_grads = jax.value_and_grad(lambda p: jt.llama_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, JCFG, attention_impl=impl,
        remat=remat))(jp)
    loss, grads = _port_grads(np_params, batch, attention_impl=impl, remat=remat)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    # the port's leaves are in insertion order, JAX's sorted: match by path
    j_by_path = {"/".join(k.key for k in path): np.asarray(g)
                 for path, g in jax.tree_util.tree_leaves_with_path(j_grads)}
    names = ["/".join(k.key for k in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(
                 params_from_numpy(np_params, device="cpu"))]
    for name, g in zip(names, grads):
        jg = j_by_path[name]
        err = float(np.abs(g.numpy() - jg).max())
        assert err <= 1e-4 * max(1.0, float(np.abs(jg).max())), f"{name}: grad err {err}"
    base_loss, base = _port_grads(np_params, batch, attention_impl=impl, remat=False)
    assert torch.equal(loss, base_loss)
    for name, g, b in zip(names, grads, base):
        assert torch.equal(g, b), f"{name}: remat={remat!r} changed the gradient"


class _CountOps(TorchDispatchMode):
    """Counts matmul calls (``aten.mm``, ``aten.bmm``) at the dispatcher."""

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def test_policies_recompute_what_jax_recomputes(params):
    """The matmuls a backward runs, less those of the no-remat backward,
    are the recomputed ones. Each layer's forward holds 7 weight products
    (``aten.mm``: q, k, v, o, w1, w3, w2) and, on the einsum path, 2
    attention products (``aten.bmm``). The w2 product's output feeds only
    the residual sum, which no backward reads, so a recompute stops before
    it: ``True``/``"nothing"`` recompute the other 6 products and both
    attention products of every layer, ``"dots_no_batch"`` and
    ``"offload_dots"`` only the attention products, ``"dots"`` nothing."""
    tp = params_from_numpy(params[1], device="cpu")
    for t in param_leaves(tp):
        t.requires_grad_(True)
    batch = {"input_ids": torch.from_numpy(_ids(4))}
    counts = {}
    for remat in [False, *POLICIES]:
        forward = _CountOps()
        with forward:
            loss = tt.llama_loss(tp, batch, TCFG, attention_impl="xla", remat=remat)
        backward = _CountOps()
        with backward:
            loss.backward()
        counts[remat] = forward.counts, backward.counts
    L = TCFG.n_layers
    assert counts[False][0] == {"mm": 7 * L + 1, "bmm": 2 * L}  # + the head
    for remat, want in {True: (6, 2), "nothing": (6, 2), "dots_no_batch": (0, 2),
                        "offload_dots": (0, 2), "dots": (0, 0)}.items():
        fwd, bwd = counts[remat]
        assert fwd == counts[False][0], remat
        recomputed = (bwd["mm"] - counts[False][1]["mm"], bwd["bmm"] - counts[False][1]["bmm"])
        assert recomputed == (want[0] * L, want[1] * L), f"remat={remat!r}: {recomputed}"


def test_remat_errors(params):
    tp = params_from_numpy(params[1], device="cpu")
    ids = torch.from_numpy(_ids(8, rows=1, seq=16))
    with pytest.raises(ValueError) as port_err:
        tt.llama_forward(tp, ids, TCFG, remat="everything")
    with pytest.raises(ValueError) as jax_err:
        jt._remat_policy("everything")
    assert str(port_err.value) == str(jax_err.value)


def test_offload_dots_equals_dots_no_batch_bitwise(params, one_thread):
    """The same saved set in another place: the gradients of
    ``"offload_dots"`` equal ``"dots_no_batch"``'s bit for bit."""
    batch = {"input_ids": _ids(5)}
    loss, grads = _port_grads(params[1], batch, attention_impl="xla", remat="offload_dots")
    base_loss, base = _port_grads(params[1], batch, attention_impl="xla", remat="dots_no_batch")
    assert torch.equal(loss, base_loss)
    assert all(torch.equal(g, b) for g, b in zip(grads, base))


def test_offload_dots_holds_the_projections_on_the_host(params, monkeypatch):
    """Between the forward and the backward each checkpointed layer's store
    holds its 7 weight products (q, k, v, o, w1, w3, w2: ``aten.mm``) as
    CPU tensors of the products' shapes; the recompute takes back all but
    w2's, whose output no backward reads."""
    stores = []
    real_init = tt._HostSaveMode.__init__

    def spy(self, saved, store):
        stores.append(store)
        real_init(self, saved, store)

    monkeypatch.setattr(tt._HostSaveMode, "__init__", spy)
    tp = params_from_numpy(params[1], device="cpu")
    for t in param_leaves(tp):
        t.requires_grad_(True)
    ids = torch.from_numpy(_ids(6))
    loss = tt.llama_loss(tp, {"input_ids": ids}, TCFG, attention_impl="xla", remat="offload_dots")
    L, D, Dkv, F = TCFG.n_layers, TCFG.dim, TCFG.n_kv_heads * TCFG.head_dim, TCFG.hidden_dim
    assert len(stores) == L
    mm = torch.ops.aten.mm.default
    for store in stores:
        assert set(store) == {mm}
        shapes = [tuple(host.shape) for host, _ in store[mm]]
        assert shapes == [(B * S, n) for n in (D, Dkv, Dkv, D, F, F, D)]
        assert all(host.device.type == "cpu" and dev.type == "cpu" for host, dev in store[mm])
    loss.backward()
    assert [len(store[mm]) for store in stores] == [1] * L


LOOP_LR = 1e-2


@pytest.mark.parametrize("precision", ["no", "bf16"])
def test_bf16_params_adafactor_loop_matches_jax(params, precision, monkeypatch, one_thread):
    """3 ``prepare_train_loop`` steps of bf16 params with ``adafactor(1e-2)``
    and ``remat="dots_no_batch"`` against the JAX ``Accelerator``'s loop on
    the same bf16 params and batches. Under "no" both sides run everything
    in bf16; under "bf16" the policy's param dtype is f32, so the JAX step
    hands adafactor f32 gradients (``cast_to_param``) and the port must too,
    which the test checks.

    Envelope: the two sides round the same bf16 ops at the same points but
    sum their bf16 matmuls (and the embedding's repeated rows) in another
    order, and XLA's CPU backend keeps some fused elementwise chains in
    f32, so gradients differ in their last bits. Each step moves a param
    by lr · rms(param), two or three bf16 ulps of the param itself, so such
    a difference flips the rounding of ``p + u`` by one ulp in about a
    fifth of the elements. Losses within 2e-4 relative (one bf16 step is
    3.9e-3); each leaf's 3-step update within 0.2 relative L2 with at least
    70 % of its elements bitwise equal. Measured (on one thread, which
    fixes the order of the embedding's backward): losses within 4.9e-5,
    updates within 0.121, 79-98 % of each leaf bitwise.
    """
    jp, _ = params
    batches = [{"input_ids": _ids(20 + k)} for k in range(3)]

    jp16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    start = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jp16)
    JAcceleratorState._reset_state(reset_partial_state=True)
    jacc = JAccelerator(mixed_precision=precision)
    jparams, jopt = jacc.prepare(jp16, optax.adafactor(LOOP_LR))
    jloop = jacc.prepare_train_loop(
        lambda p, b: jt.llama_loss(p, b, JCFG, attention_impl="xla", remat="dots_no_batch"), jopt)
    jparams, _, jm = jloop(jparams, jopt.opt_state, jstack(batches))
    j_loss = np.asarray(jm["loss"])

    seen = set()
    real = Adafactor._update
    monkeypatch.setattr(Adafactor, "_update",
                        lambda self, p, g, group: seen.add(g.dtype) or real(self, p, g, group))
    acc = Accelerator(cpu=True, mixed_precision=precision)
    t16 = jax.tree_util.tree_map(lambda x: torch.from_numpy(x).to(torch.bfloat16), start)
    tparams, opt = acc.prepare(t16, adafactor(LOOP_LR))
    loop = acc.prepare_train_loop(
        lambda p, b: tt.llama_loss(p, b, TCFG, attention_impl="xla", remat="dots_no_batch"), opt)
    tbatches = stack_batches([{k: torch.from_numpy(v) for k, v in b.items()} for b in batches])
    tparams, _, tm = loop(tparams, opt.opt_state, tbatches)
    t_loss = tm["loss"].numpy()

    assert seen == {torch.float32 if precision == "bf16" else torch.bfloat16}
    _same_bf16_steps(t_loss, j_loss, start, tparams, jparams)


def _same_bf16_steps(t_loss, j_loss, start, tparams, jparams):
    """The envelope of the bf16 loop tests (see the adafactor one)."""
    assert np.isfinite(t_loss).all() and np.isfinite(j_loss).all()
    np.testing.assert_allclose(t_loss, j_loss, rtol=2e-4)
    j_after = {"/".join(k.key for k in path): np.asarray(x, np.float32)
               for path, x in jax.tree_util.tree_leaves_with_path(jparams)}
    for path, x0 in jax.tree_util.tree_leaves_with_path(start):
        name = "/".join(k.key for k in path)
        t = tparams
        for k in path:
            t = t[k.key]
        assert t.dtype == torch.bfloat16
        got, want = t.detach().float().numpy(), j_after[name]
        if (want == x0).all():  # a step under half an ulp of every element
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        rel = np.linalg.norm((got - x0) - (want - x0)) / np.linalg.norm(want - x0)
        same = (got == want).mean()
        assert rel <= 0.2 and same >= 0.7, f"{name}: update rel L2 err {rel}, {same:.3f} bitwise"


@pytest.mark.parametrize("precision", ["no", "bf16"])
def test_bf16_params_adamw_steps_match_jax(params, precision, one_thread):
    """torch AdamW on bf16 params against ``optax.adamw(1e-3)``: 3 steps of
    ``prepare_train_loop`` against 3 calls of the JAX
    ``prepare_train_step``, under the adafactor test's envelope (measured:
    losses within 2.0e-5, updates within 0.115, 75-87 % bitwise; the norm
    scales' steps stay under half an ulp of 1.0 on both sides). The JAX
    ``prepare_train_loop`` cannot run this input: optax's first moment
    starts in bf16 and comes back f32 (``mu_dtype=None``), which its
    ``scan`` carry refuses; per-step calls retrace instead."""
    jp, _ = params
    batches = [{"input_ids": _ids(30 + k)} for k in range(3)]
    jp16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    start = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jp16)
    JAcceleratorState._reset_state(reset_partial_state=True)
    jacc = JAccelerator(mixed_precision=precision)
    jparams, jopt = jacc.prepare(jp16, optax.adamw(1e-3))
    jstep = jacc.prepare_train_step(lambda p, b: jt.llama_loss(p, b, JCFG, attention_impl="xla"),
                                    jopt)
    state, j_loss = jopt.opt_state, []
    for b in batches:
        jparams, state, m = jstep(jparams, state, {k: jnp.asarray(v) for k, v in b.items()})
        j_loss.append(float(m["loss"]))

    acc = Accelerator(cpu=True, mixed_precision=precision)
    t16 = jax.tree_util.tree_map(lambda x: torch.from_numpy(x).to(torch.bfloat16), start)
    tparams, opt = acc.prepare(t16, adamw(1e-3))
    loop = acc.prepare_train_loop(lambda p, b: tt.llama_loss(p, b, TCFG, attention_impl="xla"),
                                  opt)
    tbatches = stack_batches([{k: torch.from_numpy(v) for k, v in b.items()} for b in batches])
    tparams, _, tm = loop(tparams, opt.opt_state, tbatches)
    _same_bf16_steps(tm["loss"].numpy(), np.array(j_loss), start, tparams, jparams)

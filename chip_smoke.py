#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (the kernels are built from ``accelerate_tpu_torch/
csrc`` at first use) and no network. Phases, each of which fails the run:

1. build the CUDA kernels (one ``nvcc`` per source, in parallel);
2. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes, in bf16 and f32, with times beside the least
   time the card could take and one PyTorch library call as a yardstick;
3. the serving engine at full Llama-1B width (dim 2048, 16 layers, 32/8
   heads, vocab 32000; random bf16 weights from seed 0) answering 9 greedy
   requests — launch counters zeroed before and read after, so the run
   shows that the path went through both kernels; then ``torch.profiler``
   over 8 decode steps for the device's busy share and top kernels;
4. the cached path (chunked prefill + 16 decode steps through
   ``paged_forward`` and the kernels) against the plain full-sequence
   forward, logits compared in f32;
5. the card's name and power limit, one JSON line of kernel records, and
   a last line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np
import torch

# Kernel vs plain: f32 on both sides, another summation order. bf16: both
# accumulate in f32 and round the output once, so one bf16 step of an
# output below 2 in magnitude.
KERNEL_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# Cached path vs full forward, f32 logits (|logit| about 1 here): the two
# differ by the order of f32 sums through 16 layers, expected ~1e-4 at
# most; rounding every attention output to bf16 (the error a bf16
# accumulator would add) is expected near 1e-2 and must miss this bar —
# phase 4 checks that it does.
LOGIT_ATOL = 1e-3

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16; f32 non-tensor

CONFIG_KW = dict(vocab_size=32000, dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
                 max_seq_len=512)
ENGINE_KW = dict(num_blocks=160, block_size=16, max_slots=8, max_blocks_per_seq=32,
                 max_prefill_len=256)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, n_copies: int, iters: int) -> float:
    """Device ms per call over ``iters`` calls cycling through ``n_copies``
    input copies (together larger than the 50 MB L2, so each call finds
    its inputs cold, as a layer of the model does), by CUDA events.

    The calls are queued behind a device-side sleep that outlasts the host's
    time to queue them, so the events time the device's work and not the
    Python cost of each call; a sleep that proves too short is doubled."""
    t0 = time.perf_counter()
    for i in range(n_copies):
        fn(i)
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / n_copies * iters
    cycles = int(2e9 * 1.5 * host_s) + 1_000_000
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for it in range(iters):
            fn(it % n_copies)
        queued_s = time.perf_counter() - t0
        ev[2].record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > 1e3 * queued_s:
            return ev[1].elapsed_time(ev[2]) / iters
        cycles *= 2
    raise SmokeFailure("could not queue the timed calls behind the device sleep")


def phase_build():
    from accelerate_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    print(f"[build] {len(built)} kernel libraries in {time.perf_counter() - t0:.2f} s")
    for name, info in built.items():
        print(f"[build] {name}: {info['path'].name} nvcc {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")


def _scrambled_tables(rng, B, W, need, nb):
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((B, W), np.int32)
    used = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[used : used + n]
        used += n
    return tables


def _kernel_case(kind, dtype, dev, seed):
    """Inputs at the serving path's shapes: decode B=8, H=32, Hkv=8, D=64,
    bs=16, W=16 with ragged lengths and a null-padded row; prefill B=1 at
    S=128 / S=256 against a W=32 table whose earlier KV has landed."""
    rng = np.random.default_rng(seed)
    H, Hkv, D, bs = 32, 8, 64, 16
    if kind == "decode":
        B, S, W = 8, 1, 16
        lens = np.array([1, 17, 100, 129, 200, 255, 256, 1], np.int32)
        need = [-(-int(n) // bs) for n in lens]
        need[-1] = 0  # an inactive slot: every entry the null block
        qpos = (lens - 1)[:, None]
    else:
        B, W = 1, 32
        S, start = {"prefill128": (128, 160), "prefill256": (256, 200)}[kind]
        qpos = (start + np.arange(S, dtype=np.int32))[None]
        need = [-(-(start + S) // bs)]
    nb = sum(need) + 1
    tables = _scrambled_tables(rng, B, W, need, nb)
    q = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32)).to(dev, dtype)
    pool_bytes = 2 * nb * bs * Hkv * D * torch.tensor([], dtype=dtype).element_size()
    n_copies = max(1, math.ceil(128e6 / pool_bytes))
    pools = [tuple(torch.randn(nb, bs, Hkv, D, device=dev).to(dtype) for _ in range(2))
             for _ in range(n_copies)]
    return dict(q=q, pools=pools, tables=torch.from_numpy(tables).to(dev),
                qpos=torch.from_numpy(np.ascontiguousarray(qpos, np.int32)).to(dev),
                B=B, S=S, H=H, Hkv=Hkv, D=D, bs=bs, W=W)


def _bound(case, dtype):
    """Least time for the work these inputs need: bytes (q, out, tables,
    positions, the live KV up to each row's last attended position) over
    HBM rate vs 4*D flops per attended key per head over the type's peak."""
    elt = torch.tensor([], dtype=dtype).element_size()
    qpos = case["qpos"].cpu().numpy().astype(np.int64)
    live = int(np.sum(qpos.max(axis=1) + 1))
    attended = int(np.sum(qpos + 1))
    B, S, H, Hkv, D, W = (case[k] for k in ("B", "S", "H", "Hkv", "D", "W"))
    nbytes = 2 * B * S * H * D * elt + 2 * live * Hkv * D * elt + 4 * (B * W + qpos.size)
    flops = 4 * D * H * attended
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(dev):
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.serving.kv_pager import gather_blocks

    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}
    for kind in ("decode", "prefill128", "prefill256"):
        for dtype in (torch.bfloat16, torch.float32):
            case = _kernel_case(kind, dtype, dev, seed=len(results))
            q, pools, tables, qpos = case["q"], case["pools"], case["tables"], case["qpos"]
            if kind == "decode":
                lens = (qpos[:, 0] + 1).to(torch.int32)
                kernel = lambda i: fa.paged_attention_decode(q, *pools[i], tables, lens)  # noqa: E731
                plain = lambda i: fa.paged_attention_decode_plain(q, *pools[i], tables, lens)  # noqa: E731
            else:
                kernel = lambda i: fa.paged_attention_prefill(q, *pools[i], tables, qpos)  # noqa: E731
                plain = lambda i: fa.paged_attention_prefill_plain(q, *pools[i], tables, qpos)  # noqa: E731
            out = kernel(0)
            torch.cuda.synchronize()
            ref = plain(0)
            err = float((out.float() - ref.float()).abs().max())
            check(bool(torch.isfinite(out.float()).all()), f"{kind} {dtype}: non-finite output")
            check(err <= KERNEL_ATOL[dtype],
                  f"{kind} {dtype}: kernel vs plain max abs err {err} > {KERNEL_ATOL[dtype]}")
            # the yardstick: one SDPA call on KV gathered ahead of time
            T = case["W"] * case["bs"]
            gathered = [tuple(gather_blocks(p, tables).transpose(1, 2).contiguous() for p in kv)
                        for kv in pools]
            mask = (torch.arange(T, device=dev)[None, None, :] <= qpos[:, :, None])[:, None]
            qt = q.transpose(1, 2)
            library = lambda i: sdpa(qt, *gathered[i], attn_mask=mask, enable_gqa=True)  # noqa: E731
            lib_err = float((library(0).transpose(1, 2).float() - ref.float()).abs().max())
            n, iters = len(pools), 32  # bounded: the plain version queues ~15 launches a call
            rec = dict(max_abs_err=err, ms=time_ms(kernel, n, iters),
                       plain_ms=time_ms(plain, n, iters), library_ms=time_ms(library, n, iters))
            rec["bound_ms"], rec["bound_by"] = _bound(case, dtype)
            results[(kind, dtype)] = rec
            print(f"[kernels] {kind:10s} {str(dtype):15s} err {err:.3e} (tol "
                  f"{KERNEL_ATOL[dtype]:.1e}; sdpa err {lib_err:.3e}) kernel {rec['ms']:.4f} ms "
                  f"plain {rec['plain_ms']:.4f} ms sdpa {rec['library_ms']:.4f} ms "
                  f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")
            del gathered, pools
    return results


def phase_engine(params, config, dev):
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.serving import RequestStatus, ServingEngine

    warm = ServingEngine(params, config, **ENGINE_KW)
    warm.submit(np.arange(40), 4)
    warm.run()
    del warm

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, config.vocab_size, 128) for _ in range(8)]
    prompts[1][:64] = prompts[0][:64]  # a shared 64-token prefix
    prompts.append(rng.integers(0, config.vocab_size, 300))  # two chunks: 256 + 44
    engine = ServingEngine(params, config, **ENGINE_KW)
    reqs = [engine.submit(p, 64) for p in prompts]
    fa.paged_attention_decode.launches = 0
    fa.paged_attention_prefill.launches = 0
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention_decode": fa.paged_attention_decode.launches,
                "paged_attention_prefill": fa.paged_attention_prefill.launches}
    stats = engine.stats()
    for r in reqs:
        check(r.status is RequestStatus.FINISHED, f"request {r.rid} ended {r.status}")
        check(len(r.generated) == 64, f"request {r.rid} made {len(r.generated)} tokens")
        check(all(0 <= t < config.vocab_size for t in r.generated), "token outside the vocab")
    check(stats["prefix_cached_tokens"] >= 64, f"no prefix hit: {stats}")
    check(launches["paged_attention_prefill"] == config.n_layers * stats["prefill_chunks"] > 0,
          f"prefill launches {launches} vs {stats['prefill_chunks']} chunks")
    check(launches["paged_attention_decode"] == config.n_layers * stats["decode_steps"] > 0,
          f"decode launches {launches} vs {stats['decode_steps']} steps")
    print(f"[engine] {len(reqs)} requests finished in {wall:.3f} s wall; "
          f"{stats['prefill_chunks']} prefill chunks, {stats['decode_steps']} decode steps, "
          f"{stats['prefix_cached_tokens']} prefix-cached tokens")
    print(f"[engine] prefill {stats['prefill_tokens'] / stats['prefill_seconds']:.1f} tok/s "
          f"({stats['prefill_tokens']} tokens in {stats['prefill_seconds']:.3f} s); decode "
          f"{stats['decode_tokens'] / stats['decode_seconds']:.1f} tok/s "
          f"({stats['decode_tokens']} tokens in {stats['decode_seconds']:.3f} s)")
    print(f"[engine] launches on the main path: {launches}")
    return launches


def phase_profile(params, config, dev):
    """Where a decode step's time goes: ``torch.profiler`` over 8 steps of 8
    live requests; device busy share = summed time of the device's kernels
    and copies (one stream, so they do not overlap) over the host wall of
    the same 8 steps run without the profiler (whose host cost inflates
    the wall it watches)."""
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch.serving import ServingEngine

    def eight_steps(prof=None):
        """8 decode steps of 8 live requests (after the step that admits and
        prefills them); returns the host wall in µs."""
        rng = np.random.default_rng(2)
        engine = ServingEngine(params, config, **ENGINE_KW)
        for _ in range(8):
            engine.submit(rng.integers(0, config.vocab_size, 128), 24)
        engine.step()
        torch.cuda.synchronize()
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        for _ in range(8):
            engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
        if prof is not None:
            prof.stop()
        return wall

    plain_us = eight_steps()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    wall_us = eight_steps(prof)
    # device-side events only (kernels, copies): an operator row carries the
    # time of the kernels it launched, so summing both would count it twice
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(r[1] for r in rows)
    if not rows:
        print("[profile] the profiler recorded no device time: busy share not measured")
        return
    print(f"[profile] 8 decode steps at 8 slots: wall {plain_us / 8e3:.3f} ms/step "
          f"({wall_us / 8e3:.3f} under the profiler), device {device_us / 8e3:.3f} ms/step, "
          f"busy share {device_us / plain_us:.3f}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"[profile]   {us / 8e3:8.4f} ms/step  {count / 8:6.1f} calls/step  {key[:90]}")


def _cached_logits(params, config, tokens, n_prompt, dev, chunk=128):
    """Logits at every position of ``tokens`` through the serving path:
    ``n_prompt`` tokens prefilled in chunks of ``chunk``, then one decode
    step per remaining token, against a fresh f32 pool."""
    from accelerate_tpu_torch.serving import init_block_pool, paged_forward

    bs, W = ENGINE_KW["block_size"], ENGINE_KW["max_blocks_per_seq"]
    pool = init_block_pool(config, W + 1, bs, torch.float32, dev)
    table = torch.arange(1, W + 1, dtype=torch.int32, device=dev)[None]
    ids = torch.from_numpy(tokens).to(dev)[None]
    out = []
    for s in range(0, n_prompt, chunk):
        e = min(s + chunk, n_prompt)
        pos = torch.arange(s, e, device=dev)[None]
        logits, pool = paged_forward(params, ids[:, s:e], pool, table, pos, config, bs)
        out.append(logits[0])
    for t in range(n_prompt, len(tokens)):
        pos = torch.tensor([[t]], device=dev)
        logits, pool = paged_forward(params, ids[:, t : t + 1], pool, table, pos, config, bs)
        out.append(logits[0])
    return torch.cat(out)


def phase_cached_vs_full(params_bf16, config, dev):
    from accelerate_tpu_torch.models.transformer import llama_forward
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.serving import engine as engine_mod

    params = {k: ({kk: {kkk: t.float() for kkk, t in vv.items()} for kk, vv in v.items()}
                  if k == "layers" else {kk: t.float() for kk, t in v.items()})
              for k, v in params_bf16.items()}
    # fixed tokens: the check compares logits, not sampled tokens (with
    # random weights the largest logit flips on rounding)
    rng = np.random.default_rng(1)
    n_prompt, n_decode = 192, 16
    tokens = rng.integers(0, config.vocab_size, n_prompt + n_decode)
    cached = _cached_logits(params, config, tokens, n_prompt, dev)
    full = llama_forward(params, torch.from_numpy(tokens).to(dev)[None], config)[0]
    err = float((cached - full).abs().max())
    scale = float(full.abs().max())
    check(bool(torch.isfinite(cached).all()), "non-finite cached logits")
    check(err <= LOGIT_ATOL, f"cached path vs full forward: max abs err {err} > {LOGIT_ATOL}")

    # negative control: bf16-rounded attention outputs must miss the bar
    original = engine_mod.paged_attention

    def rounded(*args):
        return original(*args).to(torch.bfloat16).float()

    engine_mod.paged_attention = rounded
    try:
        rounded_err = float((_cached_logits(params, config, tokens, n_prompt, dev) - full)
                            .abs().max())
    finally:
        engine_mod.paged_attention = original
    check(rounded_err > LOGIT_ATOL,
          f"bf16-rounded attention err {rounded_err} is within {LOGIT_ATOL}: bar too loose")
    print(f"[cached] {n_prompt}-token prefill (128 + 64 chunks) + {n_decode} decode steps vs "
          f"full forward, f32: max abs logit err {err:.3e} (tol {LOGIT_ATOL:.0e}, max |logit| "
          f"{scale:.3f}); with bf16-rounded attention {rounded_err:.3e}")
    print(f"[cached] decode launches {fa.paged_attention_decode.launches}, prefill launches "
          f"{fa.paged_attention_prefill.launches} (cumulative, outside the main-path count)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import accelerate_tpu_torch
    from accelerate_tpu_torch import LlamaConfig, init_llama
    from accelerate_tpu_torch.utils.device import gpu_info

    # the checkout beside this script is what is checked, never a copy
    # installed elsewhere
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(accelerate_tpu_torch.__file__)))
    check(pkg_root == here, f"accelerate_tpu_torch imported from {pkg_root}, not {here}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    phase_build()
    kernel_results = phase_kernels(dev)

    config = LlamaConfig(**CONFIG_KW)
    params = init_llama(config, torch.Generator(device=dev).manual_seed(0), device=dev,
                        dtype=torch.bfloat16)
    n_params = sum(t.numel() for v in params.values() for e in v.values()
                   for t in (e.values() if isinstance(e, dict) else [e]))
    print(f"[model] {n_params / 1e9:.3f} B params in bf16, head_dim {config.head_dim}, "
          f"ffn {config.hidden_dim}")
    launches = phase_engine(params, config, dev)
    phase_profile(params, config, dev)
    phase_cached_vs_full(params, config, dev)

    records = []
    for name, kind, source, replaces in (
        ("paged_attention_decode", "decode", "accelerate_tpu_torch/csrc/paged_decode.cu",
         "accelerate_tpu/ops/flash_attention.py:619"),
        ("paged_attention_prefill", "prefill256", "accelerate_tpu_torch/csrc/paged_prefill.cu",
         "accelerate_tpu/ops/flash_attention.py:753"),
    ):
        records.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], **kernel_results[(kind, torch.bfloat16)]})
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(gpu_info()["line"])
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

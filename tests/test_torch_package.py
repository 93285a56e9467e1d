"""Guards on the port's package boundary, device rule and kernel build.

- importing every module of ``accelerate_tpu_torch`` pulls in neither
  ``jax`` nor the JAX package;
- entry points with no ``device`` refuse to run without a GPU instead of
  dropping to the CPU;
- a kernel wrapper given a CUDA tensor launches its kernel or raises — it
  never takes the plain path when no kernel library can be built;
- the builder runs one compiler per source, names libraries by content and
  raises when the compiler fails (driven with a stand-in ``nvcc`` script).
"""

import importlib
import os
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import accelerate_tpu_torch
from accelerate_tpu_torch.ops import _build
fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
fused = importlib.import_module("accelerate_tpu_torch.ops.fused_attention")
from accelerate_tpu_torch.models.convert import params_from_numpy

REPO = Path(__file__).resolve().parent.parent


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(accelerate_tpu_torch.__path__,
                                                         "accelerate_tpu_torch."))


def test_package_imports_neither_jax_nor_the_jax_package():
    mods = _all_modules()
    assert "accelerate_tpu_torch.serving.engine" in mods
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {mods!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.") or m == "accelerate_tpu"
                     or m.startswith("accelerate_tpu."))
        print(bad)
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"


def test_entry_points_refuse_to_run_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = accelerate_tpu_torch.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accelerate_tpu_torch.init_llama(cfg)
    params = accelerate_tpu_torch.init_llama(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accelerate_tpu_torch.ServingEngine(params, cfg)
    engine = accelerate_tpu_torch.ServingEngine(params, cfg, device="cpu")
    assert engine.pool["k"].device.type == "cpu"
    bert = accelerate_tpu_torch.BertConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accelerate_tpu_torch.init_bert(bert)
    bert_params = accelerate_tpu_torch.init_bert(bert, device="cpu")
    assert bert_params["pooler"]["kernel"].device.type == "cpu"
    from accelerate_tpu_torch.state import AcceleratorState

    AcceleratorState._reset_state(reset_partial_state=True)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            accelerate_tpu_torch.Accelerator()
        AcceleratorState._reset_state(reset_partial_state=True)
        assert accelerate_tpu_torch.Accelerator(cpu=True).device.type == "cpu"
        AcceleratorState._reset_state(reset_partial_state=True)
        assert accelerate_tpu_torch.Accelerator(device="cpu").device.type == "cpu"
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros(3, np.float32)})


def test_params_from_numpy_defaults_to_the_gpu(monkeypatch):
    """Weights carried over from the JAX package land on the CUDA device
    unless the CPU is asked for, like every other entry point."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"a": {"w": np.ones((2, 3), np.float32)}, "b": np.arange(4, dtype=np.int32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(tree)
    out = params_from_numpy(tree, device="cpu")
    assert out["a"]["w"].device.type == "cpu" and out["b"].dtype == torch.int32


def test_init_block_pool_defaults_to_the_gpu(monkeypatch):
    """The public KV-pool constructor resolves its device like every other
    entry point: ``None`` is the CUDA device, and the CPU only when asked."""
    from accelerate_tpu_torch.models.transformer import LlamaConfig
    from accelerate_tpu_torch.serving import init_block_pool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig(vocab_size=32, dim=16, n_layers=2, n_heads=2, n_kv_heads=1,
                      max_seq_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_block_pool(cfg, 4, 2)
    pool = init_block_pool(cfg, 4, 2, device="cpu")
    assert pool["k"].device.type == "cpu" and pool["v"].shape == (2, 4, 2, 1, cfg.head_dim)


def _cuda_typed(*shapes_dtypes):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return [torch.empty(s, dtype=d, device="cuda") for s, d in shapes_dtypes]


def _fused_call(kernel, dtype=torch.bfloat16):
    """A fused wrapper and CUDA arguments it accepts (BERT-like shapes)."""
    q, k, v, out, do = _cuda_typed(*[((2, 128, 4, 64), dtype)] * 5)
    seg, lse = _cuda_typed(((2, 128), torch.int32), ((2, 4, 128), torch.float32))
    if kernel == "fused_fwd":
        return fused.fused_attention_fwd, (q, k, v, seg, 0.125, False)
    return fused.fused_attention_bwd, (q, k, v, seg, lse, out, do, 0.125, False)


def _flash_call(kernel, D=64, block=128, dtype=torch.bfloat16):
    """A flash wrapper and CUDA arguments it accepts (Llama-like shapes)."""
    B, S, H, Hkv = 2, 256, 4, 2
    q, do = _cuda_typed(((B, S, H, D), dtype), ((B, S, H, D), dtype))
    k, v = _cuda_typed(((B, S, Hkv, D), dtype), ((B, S, Hkv, D), dtype))
    seg, ids, counts = _cuda_typed(((B, S), torch.int32), ((B, 2, 2), torch.int32),
                                   ((B, 2), torch.int32))
    lse, delta = _cuda_typed(((B, H, S), torch.float32), ((B, H, S), torch.float32))
    cfg = fa._FlashConfig(scale=0.125, causal=True, window=None, block_q=block, block_kv=block,
                          h=H, hkv=Hkv, use_seg=False)
    if kernel == "flash_fwd":
        return fa.flash_attention_fwd, (q, k, v, seg, ids, counts, cfg)
    wrapper = fa.flash_attention_dq if kernel == "flash_dq" else fa.flash_attention_dkdv
    return wrapper, (q, k, v, seg, lse, delta, do, ids, counts, cfg)


@pytest.mark.parametrize("kernel", ["decode", "prefill", "fused_fwd", "fused_bwd", "flash_fwd",
                                    "flash_dq", "flash_dkdv", "fused_fwd_fp16",
                                    "fused_bwd_fp16"])
def test_wrappers_raise_on_cuda_tensors_without_a_kernel(kernel, monkeypatch, tmp_path):
    """No library and no compiler: the wrapper raises, its plain version is
    never called and its launch counter does not move."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))

    def plain(*a, **k):
        raise AssertionError("plain path taken for a CUDA tensor")

    if kernel.startswith("flash"):
        wrapper, args = _flash_call(kernel)
        monkeypatch.setattr(fa, f"{wrapper.__name__}_reference", plain)
        before = wrapper.launches
        with pytest.raises(RuntimeError, match="nvcc not found"):
            wrapper(*args)
        assert wrapper.launches == before
        return
    if kernel.startswith("fused"):
        kind = kernel.split("_")[1]
        monkeypatch.setattr(fused, f"fused_attention_{kind}_reference", plain)
        wrapper, args = _fused_call(kernel, torch.float16 if kernel.endswith("fp16")
                                    else torch.bfloat16)
        before = wrapper.launches
        with pytest.raises(RuntimeError, match="nvcc not found"):
            wrapper(*args)
        assert wrapper.launches == before
        return
    monkeypatch.setattr(fa, f"paged_attention_{kernel}_plain", plain)
    S = 1 if kernel == "decode" else 8
    q, k, v, tables, index = _cuda_typed(
        ((2, S, 8, 64), torch.bfloat16), ((10, 16, 2, 64), torch.bfloat16),
        ((10, 16, 2, 64), torch.bfloat16), ((2, 4), torch.int32),
        ((2,) if kernel == "decode" else (2, S), torch.int32),
    )
    wrapper = getattr(fa, f"paged_attention_{kernel}")
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wrapper(q, k, v, tables, index)
    assert wrapper.launches == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v, tables, lens = _cuda_typed(
        ((2, 1, 8, 48), torch.bfloat16), ((10, 16, 2, 48), torch.bfloat16),
        ((10, 16, 2, 48), torch.bfloat16), ((2, 4), torch.int32), ((2,), torch.int32),
    )
    with pytest.raises(ValueError, match="head_dim"):
        fa.paged_attention_decode(q, k, v, tables, lens)
    q, k, v = _cuda_typed(((2, 1, 8, 64), torch.float16), ((10, 16, 2, 64), torch.float16),
                          ((10, 16, 2, 64), torch.float16))
    with pytest.raises(TypeError, match="dtypes"):
        fa.paged_attention_decode(q, k, v, tables, lens)


@pytest.mark.parametrize("q_shape,kv_shape,match", [
    ((2, 96, 4, 64), (2, 96, 4, 64), "do not take"),      # S not a multiple of 128
    ((2, 128, 4, 48), (2, 128, 4, 48), "do not take"),    # D not a multiple of 64
    ((2, 1152, 2, 64), (2, 1152, 2, 64), "do not take"),  # S > 1024
    ((2, 128, 6, 64), (2, 128, 4, 64), "do not take"),    # H not divisible by Hkv
])
def test_fused_wrappers_reject_what_the_kernels_do_not_take(q_shape, kv_shape, match):
    q, k, v = _cuda_typed((q_shape, torch.bfloat16), (kv_shape, torch.bfloat16),
                          (kv_shape, torch.bfloat16))
    with pytest.raises(ValueError, match=match):
        fused.fused_attention_fwd(q, k, v, None, 0.125, False)
    with pytest.raises(ValueError, match="does not take"):
        fused.fused_attention(q, k, v)
    # fp16 is taken (its kernels exist), but not mixed with bf16, nor f64
    q16, k16, v16 = _cuda_typed(((2, 128, 4, 64), torch.float16),
                                ((2, 128, 4, 64), torch.bfloat16), ((2, 128, 4, 64), torch.float16))
    with pytest.raises(TypeError, match="one dtype"):
        fused.fused_attention_fwd(q16, k16, v16, None, 0.125, False)
    q64 = _cuda_typed(*[((2, 128, 4, 64), torch.float64)] * 3)
    with pytest.raises(TypeError, match="one dtype"):
        fused.fused_attention_fwd(*q64, None, 0.125, False)


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_dq", "flash_dkdv"])
def test_flash_wrappers_reject_what_the_kernels_do_not_take(kernel):
    wrapper, args = _flash_call(kernel, D=16)
    with pytest.raises(ValueError, match="head_dim"):
        wrapper(*args)
    wrapper, args = _flash_call(kernel, block=32)
    with pytest.raises(ValueError, match="multiples of 64"):
        wrapper(*args)
    wrapper, args = _flash_call(kernel, dtype=torch.float16)
    with pytest.raises(TypeError, match="one dtype"):
        wrapper(*args)
    wrapper, args = _flash_call(kernel)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():  # q as 4 of 8 heads: the right shape, not contiguous
        q = torch.empty_strided((2, 256, 4, 64), (256 * 8 * 64, 8 * 64, 64, 1),
                                dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(q, *args[1:])


def _fake_nvcc(tmp_path, body):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return tmp_path / "cuda"


def test_build_compiles_each_source_once_and_caches_by_content(monkeypatch, tmp_path):
    # the stand-in compiler logs its arguments and writes its -o target
    log = tmp_path / "calls.log"
    cuda = _fake_nvcc(tmp_path, f'echo "$@" >> {log}\n'
                                'while [ $# -gt 0 ]; do [ "$1" = -o ] && touch "$2"; shift; done\n'
                                'echo "ptxas info : Used 40 registers"\n')
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.build()
    assert set(first) == set(_build.KERNELS)
    calls = log.read_text().splitlines()
    assert len(calls) == len(_build.KERNELS)
    for call in calls:
        assert "arch=compute_90a,code=sm_90a" in call and "-shared" in call
    for name, info in first.items():
        assert info["path"].exists() and info["path"].name.startswith(name + "-")
        assert "registers" in info["ptxas"]
    again = _build.build()
    assert len(log.read_text().splitlines()) == len(calls)  # up to date: no rebuild
    assert all(info["seconds"] == 0.0 for info in again.values())
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._lib_path("paged_decode") != first["paged_decode"]["path"]


def test_build_raises_with_the_compiler_log(monkeypatch, tmp_path):
    cuda = _fake_nvcc(tmp_path, 'echo "error: no such intrinsic" >&2\nexit 2\n')
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build(["paged_prefill"])
    assert not list((tmp_path / "build").glob("*.so"))


def test_kernel_sources_name_what_they_replace():
    import re

    for name in _build.KERNELS:
        text = (_build.CSRC / f"{name}.cu").read_text()
        replaced = re.search(r"Replaces: (accelerate_tpu/ops/\w+\.py) `(\w+)`", text)
        assert replaced, name
        source = REPO / replaced.group(1)
        assert source.is_file() and f"def {replaced.group(2)}(" in source.read_text()
        assert "What bounds it" in text and "What the design does" in text
        for fn in _build.KERNELS[name]:
            assert f'extern "C" int {fn}(' in text


def test_gpu_info_parses_nvidia_smi(monkeypatch, tmp_path):
    from accelerate_tpu_torch.utils import device

    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 700.00 W'\n")
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path) + os.pathsep + os.environ.get("PATH", ""))
    info = device.gpu_info()
    assert info == {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W",
                    "line": "NVIDIA H100 80GB HBM3, 700.00 W"}

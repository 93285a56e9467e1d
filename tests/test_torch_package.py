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

import os
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import accelerate_tpu_torch
from accelerate_tpu_torch.ops import _build
from accelerate_tpu_torch.ops import flash_attention as fa

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


def _cuda_typed(*shapes_dtypes):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return [torch.empty(s, dtype=d, device="cuda") for s, d in shapes_dtypes]


@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_wrappers_raise_on_cuda_tensors_without_a_kernel(kernel, monkeypatch, tmp_path):
    """No library and no compiler: the wrapper raises, its plain version is
    never called and its launch counter does not move."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))

    def plain(*a, **k):
        raise AssertionError("plain path taken for a CUDA tensor")

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
    for name in _build.KERNELS:
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert "Replaces: accelerate_tpu/ops/flash_attention.py" in text
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

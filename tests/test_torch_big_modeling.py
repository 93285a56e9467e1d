"""The port's big-model pieces (``utils.offload``, ``utils.modeling``,
``hooks``, ``big_modeling``) against the JAX package on the CPU: the cases
of ``tests/test_big_modeling.py`` on the same tiny MLP, made from numpy and
fed to both packages, and beyond them:

- sizes, ``infer_auto_device_map``, ``get_balanced_memory``,
  ``clean_device_map`` and the layer-size helpers give dict-equal results
  to JAX's for the same tree and budgets, tied weights and
  ``no_split_module_patterns`` included;
- an offload folder written by either package loads in the other, bf16
  and scalars included, bit for bit;
- ``.safetensors`` files written by ``safetensors.numpy.save_file`` (single,
  and sharded with an index) load through the port's own reader;
- ``abstract_params(init_llama, ...)`` allocates nothing;
- the ``cpu_offload_with_hook`` chain offloads model N-1 when N loads;
- the layerwise-casting hook casts as JAX's does (fp8 and bf16 storage).

Outputs of dispatched runs are compared to the plain run and to JAX's at
1e-6 relative (f32 matmuls of the same inputs, another summation order).
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from accelerate_tpu import big_modeling as jbm
from accelerate_tpu import hooks as jhooks
from accelerate_tpu.models import transformer as jt
from accelerate_tpu.utils import modeling as jmod
from accelerate_tpu.utils import offload as joff
from accelerate_tpu_torch import big_modeling as tbm
from accelerate_tpu_torch import hooks as thooks
from accelerate_tpu_torch.models import transformer as tt
from accelerate_tpu_torch.utils import modeling as tmod
from accelerate_tpu_torch.utils import offload as toff

CPU = "cpu"


def mlp_numpy(d=8, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layer1": {"w": rng.standard_normal((d, d)).astype(np.float32), "b": np.zeros(d, np.float32)},
        "layer2": {"w": rng.standard_normal((d, d)).astype(np.float32), "b": np.zeros(d, np.float32)},
        "head": {"w": rng.standard_normal((d, 2)).astype(np.float32), "b": np.zeros(2, np.float32)},
    }


def _tree(np_tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in np_tree.items()}


def as_torch(np_tree):
    return _tree(np_tree, lambda a: torch.from_numpy(np.array(a)))


def as_jax(np_tree):
    return _tree(np_tree, jnp.asarray)


def mlp_stages():
    def layer(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    def head(p, x):
        return x @ p["w"] + p["b"]

    return [("layer1", layer), ("layer2", layer), ("head", head)]


def jax_stages():
    return [("layer1", lambda p, x: jnp.tanh(x @ p["w"] + p["b"])),
            ("layer2", lambda p, x: jnp.tanh(x @ p["w"] + p["b"])),
            ("head", lambda p, x: x @ p["w"] + p["b"])]


def run_plain(params, x):
    for name, fn in mlp_stages():
        x = fn(params[name], x)
    return x


X = np.linspace(-1.0, 1.0, 32, dtype=np.float32).reshape(4, 8)


def _same_as_plain_and_jax(out, np_params, x=X):
    want = run_plain(as_torch(np_params), torch.from_numpy(x))
    torch.testing.assert_close(out, want, rtol=1e-6, atol=0)
    jout = jbm.dispatch_params(as_jax(np_params), {"": 0}).run(jax_stages(), jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6)


# ------------------------------------------------------------------- sizing --
class TestSizes:
    def test_dtype_byte_size(self):
        for dtype, want in [(np.float32, 4), ("bfloat16", 2), (np.int8, 1), ("int4", 0.5),
                            (np.float64, 8), ("float8_e4m3fn", 1), ("int2", 0.25)]:
            assert tmod.dtype_byte_size(dtype) == jmod.dtype_byte_size(dtype) == want
        for dtype, want in [(torch.float32, 4), (torch.bfloat16, 2), (torch.float16, 2),
                            (torch.float8_e4m3fn, 1), (torch.int64, 8), (torch.bool, 1)]:
            assert tmod.dtype_byte_size(dtype) == want

    def test_convert_file_size(self):
        for s in ("1KB", "1KiB", "2GB", "200MiB", "4096", 512):
            assert tmod.convert_file_size_to_int(s) == jmod.convert_file_size_to_int(s)
        with pytest.raises(ValueError):
            tmod.convert_file_size_to_int("lots")

    def test_module_sizes_equal_jax(self):
        np_params = mlp_numpy(d=8)
        sizes = tmod.compute_module_sizes(as_torch(np_params))
        assert sizes == jmod.compute_module_sizes(as_jax(np_params))
        assert sizes["layer1/w"] == 8 * 8 * 4 and sizes["layer1"] == 8 * 8 * 4 + 8 * 4
        assert sizes[""] == tmod.total_byte_size(as_torch(np_params))

    def test_module_sizes_dtype_override_never_upcasts(self):
        params = {"a": {"w": torch.zeros((4, 4), dtype=torch.bfloat16)}}
        assert tmod.compute_module_sizes(params, dtype=torch.float32)["a/w"] == 4 * 4 * 2
        assert tmod.compute_module_sizes(params, dtype=torch.bfloat16)["a/w"] == 4 * 4 * 2
        jparams = {"a": {"w": jnp.zeros((4, 4), dtype=jnp.bfloat16)}}
        assert (tmod.compute_module_sizes(params, dtype="float32")
                == jmod.compute_module_sizes(jparams, dtype=np.float32))

    def test_named_roundtrip(self):
        params = as_torch(mlp_numpy())
        flat = tmod.named_parameters(params)
        assert list(flat) == list(jmod.named_parameters(as_jax(mlp_numpy())))
        rebuilt = tmod.unflatten_parameters(flat)
        assert tmod.named_parameters(rebuilt).keys() == flat.keys()
        assert all(rebuilt[k][n] is params[k][n] for k in params for n in params[k])

    def test_abstract_params_allocates_nothing(self):
        """A 1.7 B-param f32 Llama (6.8 GB if it were made) becomes a tree of
        meta tensors of the right shapes and sizes, and the process's
        resident memory grows by far less than one of its layers."""
        cfg = tt.LlamaConfig(vocab_size=32000, dim=4096, n_layers=8, n_heads=32, n_kv_heads=8)

        def rss():
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

        before = rss()
        tree = tmod.abstract_params(tt.init_llama, cfg, device=CPU)
        grown = rss() - before
        leaves = list(tmod.named_parameters(tree).values())
        assert all(t.is_meta for t in leaves)
        total = tmod.total_byte_size(tree)
        assert total == sum(4 * t.numel() for t in leaves) > 6e9
        assert tree["layers"]["wq"]["kernel"].shape == (8, 4096, 4096)
        assert grown < 0.05 * total, f"abstract init grew resident memory by {grown} bytes"
        assert tbm.init_empty_weights is tmod.abstract_params is tbm.init_on_device

    def test_abstract_sizes_equal_jax_eval_shape(self):
        cfg_t, cfg_j = tt.LlamaConfig.tiny(), jt.LlamaConfig.tiny()
        tree = tmod.abstract_params(tt.init_llama, cfg_t, device=CPU, dtype=torch.bfloat16)
        jtree = jmod.abstract_params(
            lambda: jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                           jt.init_llama(cfg_j, jax.random.PRNGKey(0))))
        assert tmod.compute_module_sizes(tree) == jmod.compute_module_sizes(jtree)
        assert tmod.calculate_maximum_sizes(tree) == jmod.calculate_maximum_sizes(jtree)
        assert (tmod.get_max_layer_size(tree, ["layers"])
                == jmod.get_max_layer_size(jtree, ["layers"]))


class TestTiedParams:
    def test_find_and_retie(self):
        emb = torch.ones((16, 8))
        params = {"embed": {"w": emb}, "lm_head": {"w": emb}, "other": {"w": torch.zeros((2, 2))}}
        groups = tmod.find_tied_parameters(params)
        jemb = jnp.ones((16, 8))
        jgroups = jmod.find_tied_parameters({"embed": {"w": jemb}, "lm_head": {"w": jemb},
                                             "other": {"w": jnp.zeros((2, 2))}})
        assert groups == jgroups == [["embed/w", "lm_head/w"]]
        flat = tmod.named_parameters(params)
        flat["lm_head/w"] = None
        fixed = tmod.retie_parameters(tmod.unflatten_parameters(flat), groups)
        assert fixed["lm_head"]["w"] is fixed["embed"]["w"]
        assert tmod.ensure_weights_retied(fixed)["lm_head"]["w"] is fixed["embed"]["w"]

    def test_tied_checks(self):
        assert tmod.check_tied_parameters_in_config({"tie_word_embeddings": True}) == [
            ["embed_tokens", "lm_head"]]
        with pytest.warns(UserWarning, match="un-tied"):
            tmod.check_tied_parameters_on_same_device([["a/w", "b/w"]], {"a": 0, "b": "cpu"})


# --------------------------------------------------------------- device map --
def _tied_tree(lib, d=32):
    ones = torch.ones if lib == "torch" else jnp.ones
    emb = ones((64, d))
    return {"embed": {"w": emb}, "mid": {"w": ones((64, 64)), "b": ones((64,))},
            "mid2": {"w": ones((64, 64))}, "lm_head": {"w": emb}}


def _sorted(tree):
    return {k: _sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def _llama_stages(lib):
    if lib == "torch":
        from accelerate_tpu_torch.generation import unstack_layer_params

        cfg = tt.LlamaConfig.tiny()
        tree = unstack_layer_params(tmod.abstract_params(tt.init_llama, cfg, device=CPU), cfg)
        return _sorted(tree)  # jax.eval_shape hands back its dicts in sorted key order
    from accelerate_tpu.generation import unstack_layer_params

    cfg = jt.LlamaConfig.tiny()
    return jmod.abstract_params(
        lambda: unstack_layer_params(jt.init_llama(cfg, jax.random.PRNGKey(0)), cfg))


def _map_cases():
    mlp = mlp_numpy(d=8)
    sizes = jmod.compute_module_sizes(as_jax(mlp))
    yield "fits", lambda lib: (as_torch(mlp) if lib == "torch" else as_jax(mlp)), \
        {0: "1GB", "cpu": "1GB"}, None
    yield "spills", lambda lib: (as_torch(mlp) if lib == "torch" else as_jax(mlp)), \
        {0: sizes["layer1"] * 2 + 8, "cpu": sizes["layer2"] + 8}, None
    yield "no_split", lambda lib: (as_torch(mlp) if lib == "torch" else as_jax(mlp)), \
        {0: sizes["layer1"] // 2, "cpu": 10**9}, ["layer1", "layer2", "head"]
    yield "split_leaves", lambda lib: (as_torch(mlp) if lib == "torch" else as_jax(mlp)), \
        {0: 300, "cpu": 400}, None
    yield "two_devices", lambda lib: (as_torch(mlp) if lib == "torch" else as_jax(mlp)), \
        {0: 320, 1: 320, "cpu": 10**9}, None
    yield "tied", _tied_tree, {0: 10**9, "cpu": 10**9}, None
    yield "tied_spill", _tied_tree, {0: 20000, "cpu": 20000}, None
    yield "llama_layers", _llama_stages, {0: 1_200_000, "cpu": 900_000}, [r"^layer_\d+$"]
    yield "llama_split", _llama_stages, {0: 1_000_000, "cpu": 700_000}, None


MAP_CASES = list(_map_cases())


@pytest.mark.parametrize("name,make,max_memory,no_split", MAP_CASES,
                         ids=[c[0] for c in MAP_CASES])
def test_device_map_and_balanced_memory_equal_jax(name, make, max_memory, no_split):
    ttree, jtree = make("torch"), make("jax")
    got = tmod.infer_auto_device_map(ttree, max_memory=dict(max_memory),
                                     no_split_module_patterns=no_split)
    want = jmod.infer_auto_device_map(jtree, max_memory=dict(max_memory),
                                      no_split_module_patterns=no_split)
    assert list(got.items()) == list(want.items())
    raw = tmod.infer_auto_device_map(ttree, max_memory=dict(max_memory),
                                     no_split_module_patterns=no_split, clean_result=False)
    assert raw == jmod.infer_auto_device_map(jtree, max_memory=dict(max_memory),
                                             no_split_module_patterns=no_split,
                                             clean_result=False)
    assert tmod.clean_device_map(raw) == jmod.clean_device_map(raw) == got
    assert (tmod.get_balanced_memory(ttree, dict(max_memory), no_split)
            == jmod.get_balanced_memory(jtree, dict(max_memory), no_split))
    assert tmod.get_max_layer_size(ttree, no_split) == jmod.get_max_layer_size(jtree, no_split)
    tmod.check_device_map(ttree, got)


class TestDeviceMap:
    def test_all_fits_on_device_zero(self):
        dm = tmod.infer_auto_device_map(as_torch(mlp_numpy()), max_memory={0: "1GB", "cpu": "1GB"})
        assert set(dm.values()) == {0}

    def test_spills_to_cpu_then_disk(self):
        params = as_torch(mlp_numpy(d=8))
        sizes = tmod.compute_module_sizes(params)
        dm = tmod.infer_auto_device_map(
            params, max_memory={0: sizes["layer1"] * 2 + 8, "cpu": sizes["layer2"] + 8})
        values = [tmod.lookup_device(dm, p) for p in ("layer1/w", "layer2/w", "head/w")]
        assert values[0] == 0
        assert "cpu" in values or "disk" in values
        assert values[2] in ("cpu", "disk")

    def test_tied_modules_placed_together(self):
        dm = tmod.infer_auto_device_map(_tied_tree("torch"), max_memory={0: 10**9, "cpu": 10**9})
        assert tmod.lookup_device(dm, "embed/w") == tmod.lookup_device(dm, "lm_head/w")

    def test_clean_device_map_collapses(self):
        dm = tmod.clean_device_map({"a/x": 0, "a/y": 0, "b/x": 0, "b/y": "cpu"})
        assert dm["a"] == 0 and dm["b/x"] == 0 and dm["b/y"] == "cpu"

    def test_check_device_map_names_uncovered(self):
        with pytest.raises(ValueError, match="head/w"):
            tmod.check_device_map(as_torch(mlp_numpy()), {"layer1": 0, "layer2": 0})

    def test_max_memory_probe_and_override(self, monkeypatch):
        mm = tmod.get_max_memory()
        assert "cpu" in mm and mm["cpu"] > 0
        mm2 = tmod.get_max_memory({0: "1MB", "cpu": 2048})
        assert mm2 == jmod.get_max_memory({0: "1MB", "cpu": 2048})
        assert mm2[0] == 10**6 and mm2["cpu"] == 2048
        # no CUDA device: the host alone, never a made-up device budget
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert list(tmod.get_max_memory()) == ["cpu"]

    def test_balanced_memory_caps_devices(self):
        params = as_torch(mlp_numpy(d=16))
        total = tmod.total_byte_size(params)
        mm = tmod.get_balanced_memory(params, {0: 10**9, 1: 10**9, "cpu": 10**9})
        assert mm[0] < 10**9 and mm[1] < 10**9 and mm[0] + mm[1] >= total

    def test_extract_submodules_state_dict(self):
        sd = {"a/x": 1, "a.y": 2, "b/x": 3}
        assert (tmod.extract_submodules_state_dict(sd, ["a"])
                == jmod.extract_submodules_state_dict(sd, ["a"]) == {"x": 1, "y": 2})


# ------------------------------------------------------------------ offload --
class TestOffload:
    def test_offload_roundtrip(self, tmp_path):
        w = torch.randn(5, 3)
        index = toff.offload_weight(w, "w", str(tmp_path))
        toff.save_offload_index(index, str(tmp_path))
        back = toff.load_offloaded_weight(str(tmp_path / "w.dat"), index["w"])
        assert torch.equal(back, w)

    def test_offload_bfloat16(self, tmp_path):
        w = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) / 7
        index = toff.offload_weight(w, "w", str(tmp_path))
        assert index["w"] == {"dtype": "bfloat16", "shape": [2, 3]}
        back = toff.load_offloaded_weight(str(tmp_path / "w.dat"), index["w"])
        assert back.dtype == torch.bfloat16 and torch.equal(back, w)

    def test_offload_scalar(self, tmp_path):
        index = toff.offload_weight(torch.tensor(3.5), "s", str(tmp_path))
        back = toff.load_offloaded_weight(str(tmp_path / "s.dat"), index["s"])
        assert back.shape == () and float(back) == 3.5

    def test_state_dict_loader(self, tmp_path):
        sd = {"a": torch.ones((2, 2)), "b": torch.zeros((3,))}
        toff.offload_state_dict(str(tmp_path), sd)
        loader = toff.OffloadedWeightsLoader(save_folder=str(tmp_path))
        assert set(loader) == {"a", "b"}
        assert torch.equal(loader["a"], sd["a"])

    def test_prefixed_dataset(self):
        pd = toff.PrefixedDataset({"pre.a": 1, "pre.b": 2, "other": 3}, "pre.")
        assert pd["a"] == 1 and len(pd) == 2

    @staticmethod
    def _state():
        rng = np.random.default_rng(3)
        bf = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
        return {
            "layer/w": rng.standard_normal((4, 6)).astype(np.float32),
            "layer/bf": bf,
            "ids": np.arange(7, dtype=np.int32),
            "half": rng.standard_normal(5).astype(np.float16),
            "scale": np.float32(0.25),
            "bf_scalar": np.asarray(1.5, ml_dtypes.bfloat16),
        }

    def test_jax_folder_loads_in_the_port(self, tmp_path):
        state = self._state()
        joff.offload_state_dict(str(tmp_path), state)
        loader = toff.OffloadedWeightsLoader(save_folder=str(tmp_path))
        assert set(loader) == set(state)
        for name, want in state.items():
            got = loader[name]
            want = np.asarray(want)
            assert tuple(got.shape) == want.shape, name
            if want.dtype.name == "bfloat16":
                assert got.dtype == torch.bfloat16
                np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
            else:
                np.testing.assert_array_equal(got.numpy(), want, err_msg=name)

    def test_port_folder_loads_in_jax(self, tmp_path):
        state = self._state()
        tstate = {k: (torch.from_numpy(np.asarray(v).reshape(-1).view(np.int16).copy())
                      .view(torch.bfloat16).reshape(np.shape(v))
                      if np.asarray(v).dtype.name == "bfloat16" else torch.from_numpy(np.array(v)))
                  for k, v in state.items()}
        toff.offload_state_dict(str(tmp_path), tstate)
        assert (json.loads((tmp_path / "index.json").read_text())
                == {k: {"dtype": str(np.asarray(v).dtype), "shape": list(np.shape(v))}
                    for k, v in state.items()})
        loader = joff.OffloadedWeightsLoader(save_folder=str(tmp_path))
        for name, want in state.items():
            got = np.asarray(loader[name])
            want = np.asarray(want)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                          want.reshape(-1).view(np.uint8), err_msg=name)


class TestSafetensors:
    @staticmethod
    def _state():
        rng = np.random.default_rng(4)
        return {
            "a/w": rng.standard_normal((3, 4)).astype(np.float32),
            "a/bf": rng.standard_normal((2, 8)).astype(ml_dtypes.bfloat16),
            "a/h": rng.standard_normal(6).astype(np.float16),
            "b/ids": np.arange(5, dtype=np.int64),
            "b/i8": np.arange(-3, 3, dtype=np.int8),
            "b/mask": np.array([True, False, True]),
            "b/f8": rng.standard_normal(4).astype(ml_dtypes.float8_e4m3fn),
            "b/scalar": np.asarray(2.5, np.float32),
        }

    @staticmethod
    def _check(got, state):
        assert set(got) == set(state)
        for name, want in state.items():
            t = got[name]
            assert tuple(t.shape) == want.shape, name
            bits = t.reshape(-1).view(torch.uint8)
            np.testing.assert_array_equal(bits.numpy(), want.reshape(-1).view(np.uint8),
                                          err_msg=name)

    def test_single_file(self, tmp_path):
        state = self._state()
        save_file(state, str(tmp_path / "model.safetensors"), metadata={"format": "np"})
        got = tmod.load_state_dict(str(tmp_path / "model.safetensors"))
        self._check(got, state)
        assert got["a/bf"].dtype == torch.bfloat16 and got["b/f8"].dtype == torch.float8_e4m3fn
        assert tmod.load_safetensors(str(tmp_path / "model.safetensors"),
                                     names=["a/w"]).keys() == {"a/w"}

    def test_sharded_with_index(self, tmp_path):
        state = self._state()
        keys = sorted(state)
        shards = {"model-1.safetensors": keys[:4], "model-2.safetensors": keys[4:]}
        for fname, names in shards.items():
            save_file({k: state[k] for k in names}, str(tmp_path / fname))
        (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
            {"weight_map": {k: f for f, names in shards.items() for k in names}}))
        files = tmod._resolve_checkpoint_files(str(tmp_path))
        assert files == jmod._resolve_checkpoint_files(str(tmp_path))
        got = {}
        for f in files:
            got.update(tmod.load_state_dict(f))
        self._check(got, state)

    def test_offload_index_entry_in_a_safetensors_file(self, tmp_path):
        state = self._state()
        save_file(state, str(tmp_path / "m.safetensors"))
        index = {"x": {"safetensors_file": str(tmp_path / "m.safetensors"), "weight_name": "a/bf",
                       "dtype": "bfloat16", "shape": [2, 8]}}
        got = toff.OffloadedWeightsLoader(index=index)["x"]
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      state["a/bf"].view(np.int16))


# -------------------------------------------------------------------- hooks --
class TestHooks:
    def test_sequential_and_remove(self):
        calls = []

        class H(thooks.ModelHook):
            def __init__(self, tag):
                self.tag = tag

            def pre_forward(self, params, *args, **kwargs):
                calls.append(f"pre{self.tag}")
                return params, args, kwargs

            def post_forward(self, params, output):
                calls.append(f"post{self.tag}")
                return output

        fn = lambda p, x: x * p  # noqa: E731
        hooked = thooks.add_hook_to_fn(thooks.add_hook_to_fn(fn, H(1)), H(2))
        assert hooked(2.0, 3.0) == 6.0
        assert calls == ["pre1", "pre2", "post1", "post2"]
        assert thooks.remove_hook_from_fn(hooked)(2.0, 3.0) == 6.0

    def test_align_devices_hook_loads_missing(self):
        weights = {"w": np.full((2, 2), 7.0, np.float32)}
        hook = thooks.AlignDevicesHook(execution_device=CPU, weights_map=weights)
        fn = thooks.add_hook_to_fn(lambda p, x: x @ p["w"], hook)
        out = fn({"w": None}, torch.eye(2))
        assert torch.equal(out, torch.from_numpy(weights["w"]))
        assert hook.tied_params_map == {}  # cleared after the call (offload=True)

    def test_align_devices_hook_copies_a_tied_weight_once(self):
        w = torch.ones(2, 2)
        hook = thooks.AlignDevicesHook(execution_device=CPU, offload=False)
        params, _, _ = hook.pre_forward({"a": w, "b": w})
        assert params["a"] is params["b"] and len(hook.tied_params_map) == 1

    @pytest.mark.parametrize("storage", ["float8_e4m3fn", "bfloat16"])
    def test_layerwise_casting_matches_jax(self, storage):
        x = (np.random.default_rng(5).standard_normal((16, 16)) * 4).astype(np.float32)
        hook = thooks.LayerwiseCastingHook(getattr(torch, storage), torch.float32)
        jhook = jhooks.LayerwiseCastingHook(getattr(jnp, storage), jnp.float32)
        params = hook.init_hook("s", {"w": torch.from_numpy(x), "ids": torch.arange(3)})
        jparams = jhook.init_hook("s", {"w": jnp.asarray(x), "ids": jnp.arange(3)})
        assert params["w"].dtype == getattr(torch, storage) and params["ids"].dtype == torch.int64
        cast, _, _ = hook.pre_forward(params)
        jcast, _, _ = jhook.pre_forward(jparams)
        assert cast["w"].dtype == torch.float32
        np.testing.assert_array_equal(cast["w"].numpy(), np.asarray(jcast["w"]))
        wrapped, cast_fn = tbm.attach_layerwise_casting_hooks(
            lambda p, v: v @ p["w"], getattr(torch, storage), torch.float32)
        stored = cast_fn({"w": torch.from_numpy(x)})
        assert torch.equal(wrapped(stored, torch.eye(16)), cast["w"])

    def test_prefetching_loader_yields_every_stage(self):
        np_params = mlp_numpy()
        stages = [(n, fn, as_torch(np_params)[n]) for n, fn in mlp_stages()]
        x = torch.from_numpy(X)
        for name, fn, placed in thooks.PrefetchingLoader(stages, execution_device=CPU):
            x = fn(placed, x)
        _same_as_plain_and_jax(x, np_params)

    def test_cpu_offload_hook_chain(self):
        a = thooks.CpuOffloadHook(execution_device=CPU)
        b = thooks.CpuOffloadHook(execution_device=CPU, prev_hook=a)
        a.pre_forward({"w": torch.ones(2)})
        assert a._device_copy is not None
        b.pre_forward({"w": torch.ones(2)})
        assert a._device_copy is None and b._device_copy is not None


# ----------------------------------------------------------------- dispatch --
class TestDispatch:
    def test_dispatch_all_resident_matches_plain(self):
        np_params = mlp_numpy()
        dp = tbm.dispatch_params(as_torch(np_params), device_map={"": 0}, execution_device=CPU)
        _same_as_plain_and_jax(dp.run(mlp_stages(), torch.from_numpy(X)), np_params)

    def test_cpu_offload_matches_plain(self):
        np_params = mlp_numpy()
        dp = tbm.cpu_offload(as_torch(np_params), execution_device=CPU)
        _same_as_plain_and_jax(dp.run(mlp_stages(), torch.from_numpy(X)), np_params)
        assert len(dp._paged_cache) == 0  # released after run

    def test_disk_offload_matches_plain(self, tmp_path):
        np_params = mlp_numpy()
        dp = tbm.disk_offload(as_torch(np_params), str(tmp_path), execution_device=CPU)
        assert os.path.exists(tmp_path / "index.json")
        _same_as_plain_and_jax(dp.run(mlp_stages(), torch.from_numpy(X)), np_params)

    def test_mixed_map(self, tmp_path):
        np_params = mlp_numpy()
        dp = tbm.dispatch_params(as_torch(np_params),
                                 device_map={"layer1": 0, "layer2": "cpu", "head": "disk"},
                                 offload_folder=str(tmp_path), execution_device=CPU)
        _same_as_plain_and_jax(dp.run(mlp_stages(), torch.from_numpy(X)), np_params)

    @pytest.mark.parametrize("device_map", ["auto", "balanced"])
    def test_auto_and_balanced_maps_run(self, device_map, tmp_path):
        np_params = mlp_numpy()
        dp = tbm.dispatch_params(as_torch(np_params), device_map=device_map,
                                 max_memory={0: 300, "cpu": 400}, offload_folder=str(tmp_path),
                                 execution_device=CPU)
        assert set(dp.device_map.values()) - {0, "cpu", "disk"} == set()
        _same_as_plain_and_jax(dp.run(mlp_stages(), torch.from_numpy(X)), np_params)

    def test_materialize(self):
        np_params = mlp_numpy()
        full = tbm.cpu_offload(as_torch(np_params), execution_device=CPU).materialize()
        assert torch.equal(full["layer1"]["w"], torch.from_numpy(np_params["layer1"]["w"]))

    def test_device_rule(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbm.cpu_offload(as_torch(mlp_numpy()))
        with pytest.raises(ValueError, match="only 1 local devices"):
            tbm.dispatch_params(as_torch(mlp_numpy()), {"": 1}, execution_device=CPU)

    def test_cpu_offload_with_hook_round_trip(self):
        params = {"w": torch.arange(8, dtype=torch.float32).reshape(2, 4)}
        dev_params, hook = tbm.cpu_offload_with_hook(params, execution_device=CPU)
        assert torch.equal(dev_params["w"], params["w"])
        hook.offload()
        assert torch.equal(hook.load()["w"], params["w"])
        hook.remove()

    def test_cpu_offload_with_hook_chain_offloads_the_previous_model(self):
        """Loading model N offloads model N-1 (and only it), as in JAX."""
        models = [{"w": torch.full((2,), float(i))} for i in range(3)]
        hooks, prev = [], None
        for m in models:
            _, prev = tbm.cpu_offload_with_hook(m, execution_device=CPU, prev_module_hook=prev)
            hooks.append(prev)
        assert [h._on_device is None for h in hooks] == [True, True, False]
        hooks[1].load()  # model 1 again: its previous model (0) is offloaded, 2 stays
        assert [h._on_device is None for h in hooks] == [True, False, False]
        jhooks_ = []
        jprev = None
        for m in models:
            _, jprev = jbm.cpu_offload_with_hook({"w": m["w"].numpy()}, prev_module_hook=jprev)
            jhooks_.append(jprev)
        jhooks_[1].load()
        assert [h._on_device is None for h in jhooks_] == [True, False, False]
        assert torch.equal(hooks[0].params["w"], models[0]["w"])


class TestLoadCheckpointAndDispatch:
    @staticmethod
    def _abstract(np_params):
        # jax.eval_shape hands back its dicts in sorted key order
        return tmod.abstract_params(lambda: _sorted(as_torch(np_params)))

    def test_roundtrip_single_file(self, tmp_path):
        np_params = mlp_numpy()
        save_file(dict(jmod.named_parameters(np_params)), str(tmp_path / "model.safetensors"))
        dp = tbm.load_checkpoint_and_dispatch(self._abstract(np_params),
                                              str(tmp_path / "model.safetensors"),
                                              device_map={"": 0}, execution_device=CPU)
        _same_as_plain_and_jax(dp.run(mlp_stages(), torch.from_numpy(X)), np_params)

    def test_roundtrip_sharded_with_disk(self, tmp_path):
        np_params = mlp_numpy()
        flat = dict(jmod.named_parameters(np_params))
        keys = sorted(flat)
        half = len(keys) // 2
        save_file({k: flat[k] for k in keys[:half]}, str(tmp_path / "shard-1.safetensors"))
        save_file({k: flat[k] for k in keys[half:]}, str(tmp_path / "shard-2.safetensors"))
        index = {"weight_map": {k: ("shard-1.safetensors" if k in keys[:half]
                                    else "shard-2.safetensors") for k in keys}}
        (tmp_path / "model.safetensors.index.json").write_text(json.dumps(index))
        dp = tbm.load_checkpoint_and_dispatch(
            self._abstract(np_params), str(tmp_path),
            device_map={"layer1": 0, "layer2": "cpu", "head": "disk"},
            offload_folder=str(tmp_path / "offload"), execution_device=CPU)
        assert os.path.exists(tmp_path / "offload" / "head" / "w.dat")
        _same_as_plain_and_jax(dp.run(mlp_stages(), torch.from_numpy(X)), np_params)

    def test_npz_with_inferred_map_and_dtype(self, tmp_path):
        np_params = mlp_numpy()
        np.savez(tmp_path / "model.npz", **dict(jmod.named_parameters(np_params)))
        sizes = tmod.compute_module_sizes(self._abstract(np_params), dtype=torch.bfloat16)
        dp = tbm.load_checkpoint_and_dispatch(
            self._abstract(np_params), str(tmp_path / "model.npz"),
            max_memory={0: sizes["layer1"] + sizes["layer2"], "cpu": sizes["head"]},
            offload_folder=str(tmp_path / "off"), dtype=torch.bfloat16, execution_device=CPU)
        assert list(dp.device_map.items()) == list(jmod.infer_auto_device_map(
            jmod.abstract_params(lambda: as_jax(np_params)),
            max_memory={0: sizes["layer1"] + sizes["layer2"], "cpu": sizes["head"]},
            dtype="bfloat16").items())
        full = dp.materialize()
        for k, v in tmod.named_parameters(full).items():
            assert v.dtype == torch.bfloat16
            assert torch.equal(v, torch.from_numpy(jmod.named_parameters(np_params)[k])
                               .to(torch.bfloat16))

    def test_missing_tensor_raises(self, tmp_path):
        np_params = mlp_numpy()
        save_file(dict(jmod.named_parameters({"layer1": np_params["layer1"]})),
                  str(tmp_path / "model.safetensors"))
        with pytest.raises(KeyError):
            tbm.load_checkpoint_and_dispatch(self._abstract(np_params),
                                             str(tmp_path / "model.safetensors"),
                                             device_map={"": 0}, execution_device=CPU)

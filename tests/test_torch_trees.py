"""Param trees with lists cross into the port and back unchanged.

JAX pytrees hold lists: ``init_resnet`` gives each stage as a list of
block dicts. The port's tree helpers must take list (and tuple) nodes as
JAX does and give back the same container type: ``params_from_numpy`` /
``params_to_numpy`` bitwise, ``param_leaves`` every leaf (list items by
index; dict keys in insertion order, where ``jax.tree_util`` sorts them, so
leaves are matched to JAX's by path), and the accelerator's tree walks
(``prepare`` places every leaf, ``prepare_train_loop`` slices list
batches).
"""

import jax
import numpy as np
import pytest
import torch

from accelerate_tpu.models.resnet import ResNetConfig as JResNetConfig
from accelerate_tpu.models.resnet import init_resnet as j_init_resnet
from accelerate_tpu_torch import accelerator as tacc
from accelerate_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from accelerate_tpu_torch.optimizer import param_leaves
from accelerate_tpu_torch.state import AcceleratorState, GradientState


def _jax_tree():
    return jax.tree_util.tree_map(np.asarray, j_init_resnet(JResNetConfig.tiny(),
                                                            jax.random.PRNGKey(0)))


def _walk(a, b):
    """Same containers (type, keys, order, length) and bitwise-equal leaves."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _walk(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _walk(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_list_tree_crosses_bitwise_with_lists_kept():
    tree = _jax_tree()
    assert isinstance(tree["stage_0"], list) and isinstance(tree["stage_0"][0], dict)
    port = params_from_numpy(tree, device="cpu")
    assert isinstance(port["stage_0"], list)
    assert isinstance(port["stage_1"][0]["conv2"]["kernel"], torch.Tensor)
    _walk(tree, params_to_numpy(port))
    as_tuple = params_from_numpy({"s": tuple(tree["stage_0"])}, device="cpu")
    assert isinstance(as_tuple["s"], tuple)
    assert isinstance(params_to_numpy(as_tuple)["s"], tuple)


def test_param_leaves_finds_every_jax_leaf_in_order():
    tree = _jax_tree()
    port = params_from_numpy(tree, device="cpu")
    leaves = param_leaves(port)
    with_path = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(leaves) == len(with_path) == len(jax.tree_util.tree_leaves(tree))
    by_path = {jax.tree_util.keystr(p): leaf for p, leaf in with_path}

    def paths(node, prefix=""):  # insertion order, list items by index
        if isinstance(node, dict):
            return [q for k, v in node.items() for q in paths(v, f"{prefix}['{k}']")]
        if isinstance(node, (list, tuple)):
            return [q for i, v in enumerate(node) for q in paths(v, f"{prefix}[{i}]")]
        return [prefix]

    order = paths(tree)
    assert sorted(order) == sorted(by_path)
    for path, leaf in zip(order, leaves):
        np.testing.assert_array_equal(leaf.numpy(), by_path[path])
    # within one list, JAX's order is the index order, as in the port's
    stage = [jax.tree_util.keystr(p) for p, _ in with_path if "stage_1" in jax.tree_util.keystr(p)]
    assert [p for p in order if "stage_1" in p][0].startswith("['stage_1'][0]")
    assert stage[0].startswith("['stage_1'][0]")


def test_accelerator_walks_list_trees():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    tree = _jax_tree()
    acc = tacc.Accelerator(cpu=True)
    assert tacc._is_param_tree(tree)
    params = acc.prepare(tree)
    assert isinstance(params["stage_0"], list)
    assert len(param_leaves(params)) == len(jax.tree_util.tree_leaves(tree))
    assert all(t.requires_grad for t in param_leaves(params))
    batches = {"x": [torch.arange(6).reshape(3, 2), torch.zeros(3, 1)]}
    assert tacc._leading_dim(batches) == 3
    one = tacc._step_slice(batches, 1)
    assert isinstance(one["x"], list)
    assert torch.equal(one["x"][0], torch.tensor([2, 3]))
    with pytest.raises(ValueError):
        tacc._leading_dim({"x": []})

"""PyTorch/CUDA port of ``accelerate_tpu``.

The JAX package beside this one is the reference; every module here keeps
the module name of its counterpart there, so ``accelerate_tpu_torch.serving.
engine`` ports ``accelerate_tpu.serving.engine``. This package imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of
``accelerate_tpu`` — and its entry points run on the CUDA device unless the
caller asks for ``device="cpu"``.

Ported so far:

- serving: the paged serving engine — the Llama decoder
  (``models.transformer``), the host-side block allocator and scheduler
  (``serving``), and two hand-written Hopper paged-attention kernels
  (``ops.flash_attention`` over ``csrc/paged_*.cu``); sampling from
  ``jax.random``'s exact threefry streams (``utils.random``,
  ``generation.sample_token_logits``), speculative decoding with a
  truncated-layer self-draft (``draft_config``/``draft_params``), static
  batching, the admission watermark, ``prefix_cache=False`` and resuming
  from ``generated`` tokens;
- training: BERT (``models.transformer``) through ``Accelerator.prepare``
  and ``prepare_train_loop`` (``accelerator``, ``optimizer``,
  ``data_loader``, ``state``), with the fused attention forward and
  backward kernels (``ops.fused_attention`` over
  ``csrc/fused_attention_*.cu``);
- Llama training: ``llama_forward`` with ``attention_impl``, packed
  ``segment_ids`` and per-segment positions, and ``llama_loss``
  (``models.transformer``), ``utils.packing``, and the blocked flash
  attention forward, dq and dk/dv kernels (``ops.flash_attention`` over
  ``csrc/flash_*.cu``) behind ``flash_attention`` and
  ``dot_product_attention(impl="flash")``;
- training-loop options: gradient accumulation (``optax.MultiSteps``'
  semantics in ``optimizer``), ``mixed_precision="fp16"`` with dynamic loss
  scaling (``GradScalerConfig``; the fused attention kernels in fp16 too),
  the optax schedules and ``AcceleratedScheduler`` (``scheduler``),
  ``DummyOptim``/``DummyScheduler``, ``has_aux``, ``compute_grad_norm``,
  ``accumulate``, ``no_sync``, ``gradient_fn`` and the eager clips;
- ``llama_forward(remat=...)`` with JAX's policies (``torch.utils.
  checkpoint`` per layer), ``optimizer.adafactor`` (optax's chain and
  dtypes), ``chain(clip_by_global_norm(...), tx)``, and bf16 params
  through ``prepare_train_loop``;
- generation and big-model inference: KV-cache ``greedy_generate``,
  ``sample_generate`` (JAX's one-key-per-step streams), ``beam_generate``
  and the offloaded ``generate_dispatched`` (``generation``); device maps,
  CPU and disk offload with pinned host memory and one-ahead prefetch on a
  side stream, ``load_checkpoint_and_dispatch`` from ``.npz`` or
  ``.safetensors`` (``big_modeling``, ``hooks``, ``utils.modeling``,
  ``utils.offload``); ``llama_forward(remat="offload_dots")``;
- the rest of the model zoo: ResNet (``models.resnet``, NHWC at the API,
  cuDNN convolutions in channels-last memory) with ``optimizer.sgd``, T5
  (``models.t5``) with ``optimizer.adam``, and the MoE FFN
  (``parallel.moe``) in every Llama path: training, generation and the
  serving engine. Param trees may hold lists, as JAX pytrees do;
- more than one process: one process per device in a ``torch.distributed``
  group (``state``; torchrun's or the JAX package's launcher environment),
  ``ParallelismConfig`` and its mesh (``parallelism_config``), the
  collectives (``utils.operations``), the sharding plan and sharded Llama
  training under DP, FSDP, TP and fused ZeRO-1 (``parallel.sharding``,
  ``parallel.weight_update``, ``Accelerator(parallelism_config=...)``,
  ``llama_loss(mesh=...)``), data loading across processes
  (``data_loader``), and the multi-process test launcher (``test_utils``);
- checkpoints and trackers: ``save_state``/``load_state`` in the JAX
  package's layout and formats, blocking or async (``checkpointing``,
  ``checkpoint_async``), sharded per process under a mesh
  (``sharded_checkpoint`` over ``native.io``), ``save_model``, the
  trackers (``tracking``), the HF converters (``models.convert``) and the
  ``Accelerator``'s small helpers; ``utils.api_boundary`` lists the public
  names of ``accelerate_tpu`` still to port, with their items;
- fp8 training and weight quantization: delayed-scaling ``fp8_dot``
  (``ops.fp8``, ``torch._scaled_mm`` on the card) through Llama and BERT
  (``dtype_recipe="fp8"``), ``Accelerator(mixed_precision="fp8")`` and its
  optimizer partition, fused ZeRO-1 and ``LayerStack``; blockwise int8 and
  NF4/fp4 ``QuantizedArray`` weights (``ops.quantization``,
  ``utils.quantization``) through generation and the serving engine, and
  the int8×int8 ``int8_dynamic_matmul`` (``torch._int_mm`` on the card);
- fleet serving: thread and process replicas of the engine
  (``serving.replica``), the router with admission control, failover,
  self-heal and correctness canaries (``serving.router``,
  ``serving.admission``, ``serving.canary``), disaggregated prefill/decode
  joined by a KV handoff in the JAX package's wire form
  (``serving.disagg``), the decode tier's autoscaler
  (``serving.autoscaler``) and the SLO burn-rate monitor
  (``telemetry.slo``).
"""

from .accelerator import Accelerator
from .checkpointing import load_checkpoint_in_model
from .optimizer import AcceleratedOptimizer
from .sharded_checkpoint import CheckpointCorruptError, CheckpointTopologyError
from .utils.random import synchronize_rng_states
from .data_loader import DataLoader, skip_first_batches
from .optimizer import (
    constant_schedule,
    cosine_decay_schedule,
    linear_schedule,
    warmup_cosine_decay_schedule,
)
from .parallelism_config import ParallelismConfig
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState, PartialState
from .utils.dataclasses import (
    AutocastConfig,
    AutocastKwargs,
    CheckpointConfig,
    DataLoaderConfiguration,
    DDPCommunicationHookType,
    DeepSpeedPlugin,
    DistributedDataParallelKwargs,
    DistributedType,
    DummyOptim,
    DummyScheduler,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    GradScalerConfig,
    GradScalerKwargs,
    InitProcessGroupKwargs,
    LoggerType,
    MegatronLMPlugin,
    MixedPrecisionPolicy,
    PrecisionType,
    ProjectConfiguration,
    SaveFormat,
)
from .big_modeling import (
    DispatchedParams,
    UserCpuOffloadHook,
    cpu_offload,
    cpu_offload_with_hook,
    disk_offload,
    dispatch_model,
    dispatch_params,
    init_empty_weights,
    init_on_device,
    load_checkpoint_and_dispatch,
)
from .generation import (
    beam_generate,
    generate_dispatched,
    generation_shardings,
    greedy_generate,
    init_kv_cache,
    sample_generate,
    sample_token_logits,
    serving_shardings,
    unstack_layer_params,
)
from .models.transformer import (
    BertConfig,
    LlamaConfig,
    bert_forward,
    bert_loss,
    bert_shard_rules,
    draft_config,
    draft_params,
    init_bert,
    init_llama,
    llama_forward,
    llama_loss,
    llama_shard_rules,
)
from .models.resnet import ResNetConfig, init_resnet, resnet_forward, resnet_loss
from .models.t5 import (
    T5Config,
    init_t5,
    t5_decode,
    t5_encode,
    t5_forward,
    t5_greedy_generate,
    t5_loss,
)
from .parallel.moe import init_moe_ffn, moe_ffn
from .serving.buckets import BucketLattice
from .serving.engine import ServingEngine, paged_forward
from .serving.scheduler import Request, RequestStatus
from .ops.flash_attention import flash_attention  # after serving: the two import each other
from .utils.quantization import (
    QuantizationConfig,
    QuantizedArray,
    dequantize_params,
    load_and_quantize_model,
    quantize_params,
)
from .utils.modeling import (
    abstract_params,
    compute_module_sizes,
    find_tied_parameters,
    get_balanced_memory,
    get_max_memory,
    infer_auto_device_map,
    load_checkpoint_in_params,
)

__all__ = [
    "AcceleratedOptimizer",
    "AcceleratedScheduler",
    "Accelerator",
    "AutocastConfig",
    "AutocastKwargs",
    "CheckpointConfig",
    "CheckpointCorruptError",
    "CheckpointTopologyError",
    "GradScalerKwargs",
    "LoggerType",
    "MixedPrecisionPolicy",
    "PrecisionType",
    "ProjectConfiguration",
    "SaveFormat",
    "load_checkpoint_in_model",
    "synchronize_rng_states",
    "AcceleratorState",
    "BertConfig",
    "BucketLattice",
    "DataLoader",
    "DDPCommunicationHookType",
    "DataLoaderConfiguration",
    "DeepSpeedPlugin",
    "DistributedDataParallelKwargs",
    "FullyShardedDataParallelPlugin",
    "InitProcessGroupKwargs",
    "MegatronLMPlugin",
    "DispatchedParams",
    "DistributedType",
    "DummyOptim",
    "DummyScheduler",
    "GradScalerConfig",
    "GradientAccumulationPlugin",
    "GradientState",
    "LlamaConfig",
    "ParallelismConfig",
    "PartialState",
    "QuantizationConfig",
    "QuantizedArray",
    "Request",
    "RequestStatus",
    "ResNetConfig",
    "ServingEngine",
    "T5Config",
    "UserCpuOffloadHook",
    "abstract_params",
    "beam_generate",
    "bert_forward",
    "bert_loss",
    "bert_shard_rules",
    "compute_module_sizes",
    "constant_schedule",
    "cosine_decay_schedule",
    "cpu_offload",
    "cpu_offload_with_hook",
    "dequantize_params",
    "disk_offload",
    "dispatch_model",
    "dispatch_params",
    "draft_config",
    "draft_params",
    "find_tied_parameters",
    "flash_attention",
    "generate_dispatched",
    "generation_shardings",
    "get_balanced_memory",
    "get_max_memory",
    "greedy_generate",
    "infer_auto_device_map",
    "init_bert",
    "init_empty_weights",
    "init_kv_cache",
    "init_llama",
    "init_moe_ffn",
    "init_on_device",
    "init_resnet",
    "init_t5",
    "linear_schedule",
    "llama_forward",
    "llama_loss",
    "llama_shard_rules",
    "load_and_quantize_model",
    "load_checkpoint_and_dispatch",
    "load_checkpoint_in_params",
    "moe_ffn",
    "paged_forward",
    "quantize_params",
    "resnet_forward",
    "resnet_loss",
    "sample_generate",
    "sample_token_logits",
    "serving_shardings",
    "skip_first_batches",
    "t5_decode",
    "t5_encode",
    "t5_forward",
    "t5_greedy_generate",
    "t5_loss",
    "unstack_layer_params",
    "warmup_cosine_decay_schedule",
]

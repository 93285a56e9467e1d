from .convert import params_from_numpy, params_to_numpy
from .resnet import ResNetConfig, init_resnet, resnet_forward, resnet_loss
from .t5 import (
    T5Config,
    init_t5,
    t5_decode,
    t5_encode,
    t5_forward,
    t5_greedy_generate,
    t5_loss,
)
from .transformer import (
    BertConfig,
    LlamaConfig,
    bert_forward,
    bert_loss,
    draft_config,
    draft_params,
    init_bert,
    init_llama,
    llama_forward,
    llama_loss,
)

__all__ = [
    "BertConfig",
    "LlamaConfig",
    "ResNetConfig",
    "T5Config",
    "bert_forward",
    "bert_loss",
    "draft_config",
    "draft_params",
    "init_bert",
    "init_llama",
    "init_resnet",
    "init_t5",
    "llama_forward",
    "llama_loss",
    "params_from_numpy",
    "params_to_numpy",
    "resnet_forward",
    "resnet_loss",
    "t5_decode",
    "t5_encode",
    "t5_forward",
    "t5_greedy_generate",
    "t5_loss",
]

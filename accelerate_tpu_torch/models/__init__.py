from .convert import params_from_numpy, params_to_numpy
from .transformer import LlamaConfig, init_llama, llama_forward

__all__ = ["LlamaConfig", "init_llama", "llama_forward", "params_from_numpy", "params_to_numpy"]

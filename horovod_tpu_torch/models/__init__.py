"""Decode-mode models of the port (paged serving)."""
from .convert import (  # noqa: F401
    gpt_from_flax, init_gpt_params, init_llama_params, llama_from_flax,
)
from .gpt import GPT, GPTConfig  # noqa: F401
from .llama import Llama, Llama_1B, LlamaConfig  # noqa: F401

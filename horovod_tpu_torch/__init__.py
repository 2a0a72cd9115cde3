"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

A second package beside the JAX one (which stays the reference). This
slice ports paged greedy serving: the serve knobs, the metrics
registry, the admission queue, the paged KV cache and radix prefix
cache, the Llama and GPT decode paths, the executor, the continuous
batcher, the HTTP front end and the paged-attention kernel, written in
CUDA C++ for Hopper (``ops/csrc/paged_attention.cu``).

Entry points take ``device=None``, which means ``"cuda"`` and raises
when CUDA is absent; ``device="cpu"`` runs the plain PyTorch versions.
The package imports torch, numpy and the stdlib only.
"""
from .core.config import Config                                # noqa: F401
from .models import (                                          # noqa: F401
    GPT, GPTConfig, Llama, Llama_1B, LlamaConfig, gpt_from_flax,
    init_gpt_params, init_llama_params, llama_from_flax,
)
from .ops.paged import (                                       # noqa: F401
    paged_attention_fused, resolve_kernel, sample_greedy,
)
from .serve import (                                           # noqa: F401
    AdmissionQueue, AdmitDropped, BlockPool, ContinuousBatcher,
    PagedKVCache, RadixPrefixCache, Rejected, ServeHandle, ServeRequest,
    ShardedExecutor, make_server, masked_attention, paged_attention,
    paged_model_kwargs, pool_blocks_for, serve_http, write_kv_paged,
)

__version__ = "0.1.0"

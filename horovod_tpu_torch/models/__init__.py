"""Models of the port: Llama / GPT (training, and paged decode for
serving) and the ResNet family (data-parallel training)."""
from .convert import (  # noqa: F401
    gpt_from_flax, init_gpt_params, init_llama_params, init_resnet_params,
    llama_from_flax, resnet_from_flax,
)
from .gpt import GPT, GPTConfig  # noqa: F401
from .llama import Llama, Llama_1B, LlamaConfig  # noqa: F401
from .resnet import (  # noqa: F401
    BottleneckBlock, ResNet, ResNet18, ResNet34, ResNet50, ResNet101,
    ResNet152, ResNetBlock, space_to_depth, stem_kernel_to_s2d,
)

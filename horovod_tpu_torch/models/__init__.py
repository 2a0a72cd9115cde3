"""Models of the port: Llama / GPT (training, and paged decode for
serving), the image classifiers ResNet, VGG, Inception V3 and ViT
(data-parallel training)."""
from .convert import (  # noqa: F401
    gpt_from_flax, inception_from_flax, init_gpt_params,
    init_inception_params, init_llama_params, init_resnet_params,
    init_vgg_params, init_vit_params, llama_from_flax, resnet_from_flax,
    vgg_from_flax, vit_from_flax,
)
from .gpt import GPT, GPTConfig  # noqa: F401
from .inception import InceptionV3  # noqa: F401
from .llama import Llama, Llama_1B, LlamaConfig  # noqa: F401
from .resnet import (  # noqa: F401
    BottleneckBlock, ResNet, ResNet18, ResNet34, ResNet50, ResNet101,
    ResNet152, ResNetBlock, space_to_depth, stem_kernel_to_s2d,
)
from .vgg import VGG, VGG16, VGG19  # noqa: F401
from .vit import (  # noqa: F401
    ViT, ViT_B, ViT_S, ViT_Tiny, ViTConfig, vit_partition_rules,
)

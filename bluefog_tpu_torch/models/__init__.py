"""Models of the port: the transformer LM and the vision zoo."""

from .fold import fold_batchnorm
from .layers import classification_loss
from .mlp import MLP, LeNet5
from .resnet import (BasicBlock, BottleneckBlock, ResNet, ResNet18, ResNet34,
                     ResNet50, ResNet101)
from .transformer import (MoEBlock, MoETransformerLM, TransformerLM,
                          apply_rope, lm_loss)
from .vgg import VGG, VGG11, VGG16, VGG19

__all__ = ["TransformerLM", "MoETransformerLM", "MoEBlock", "apply_rope",
           "lm_loss", "MLP", "LeNet5",
           "ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
           "BasicBlock", "BottleneckBlock", "VGG", "VGG11", "VGG16", "VGG19",
           "fold_batchnorm", "classification_loss"]

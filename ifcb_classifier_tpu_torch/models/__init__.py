"""Model zoo of the port. Only inception_v3 is ported so far; every other
family the JAX package serves raises, naming the ROADMAP item that ports it.
"""

from __future__ import annotations

__all__ = ["get_namebrand_model", "MODEL_FAMILIES", "input_size_for"]

MODEL_FAMILIES = (
    "inception_v3", "alexnet", "squeezenet",
    "vgg11", "vgg13", "vgg16", "vgg19",
    "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn",
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "densenet121", "densenet161", "densenet169", "densenet201",
    "efficientnet_b0", "efficientnet_b1", "efficientnet_b2", "efficientnet_b3",
    "efficientnet_b4", "efficientnet_b5", "efficientnet_b6", "efficientnet_b7",
)


def input_size_for(model_name: str) -> int:
    """The reference's input-size rule: 299 iff inception_v3 else 224
    (neuston_data.py:344)."""
    return 299 if model_name == "inception_v3" else 224


def get_namebrand_model(model_name: str, num_o_classes: int,
                        pretrained: bool = False, fold_bn: bool = False):
    """name → nn.Module with a ``num_o_classes``-way head (eval-only for
    now). ``pretrained`` carries torchvision's transform_input rule for
    inception_v3. Raises KeyError for unknown names, like the reference."""
    if model_name == "inception_v3":
        from .inception import InceptionV3
        return InceptionV3(num_classes=num_o_classes,
                           transform_input=bool(pretrained), fold=fold_bn)
    if model_name in MODEL_FAMILIES:
        raise NotImplementedError(
            f"{model_name!r} is not ported yet (ROADMAP P7: the other "
            "families)")
    raise KeyError("model unknown!")

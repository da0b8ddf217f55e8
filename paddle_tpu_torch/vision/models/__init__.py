from .lenet import LeNet  # noqa: F401
from .mobilenet import (MobileNetV1, MobileNetV2,  # noqa: F401
                        mobilenet_v1, mobilenet_v2)
from .resnet import (ResNet, resnet18, resnet34, resnet50,  # noqa: F401
                     resnet101, resnet152, wide_resnet50_2, wide_resnet101_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .yolov3 import YOLOv3, yolov3  # noqa: F401

__all__ = ["LeNet", "MobileNetV1", "MobileNetV2", "mobilenet_v1",
           "mobilenet_v2", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "wide_resnet50_2", "wide_resnet101_2",
           "VGG", "vgg11", "vgg13", "vgg16", "vgg19", "YOLOv3", "yolov3"]

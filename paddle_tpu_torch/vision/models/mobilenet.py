"""MobileNetV1/V2 (reference python/paddle/vision/models/mobilenetv1.py,
mobilenetv2.py); counterpart of ``paddle_tpu/vision/models/mobilenet.py``:
the same layers in the same order, so the state dict keys are the JAX
package's.  Depthwise convolutions are ``Conv2D`` with ``groups`` equal
to the channels (the ``conv2d`` lowering, on cuDNN on the card)."""
from ... import nn


class ConvBNLayer(nn.Layer):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0, groups=1,
                 act="relu6"):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, kernel, stride=stride,
                              padding=padding, groups=groups, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.act = nn.ReLU6() if act == "relu6" else (
            nn.ReLU() if act == "relu" else None)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, out_c1, out_c2, stride, scale=1.0):
        super().__init__()
        c1 = int(out_c1 * scale)
        c2 = int(out_c2 * scale)
        self.dw = ConvBNLayer(in_c, c1, 3, stride=stride, padding=1,
                              groups=in_c, act="relu")
        self.pw = ConvBNLayer(c1, c2, 1, act="relu")

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        s = lambda c: int(c * scale)
        self.conv1 = ConvBNLayer(3, s(32), 3, stride=2, padding=1, act="relu")
        cfg = [(32, 32, 64, 1), (64, 64, 128, 2), (128, 128, 128, 1),
               (128, 128, 256, 2), (256, 256, 256, 1), (256, 256, 512, 2)] + \
              [(512, 512, 512, 1)] * 5 + \
              [(512, 512, 1024, 2), (1024, 1024, 1024, 1)]
        blocks = []
        for in_c, c1, c2, stride in cfg:
            blocks.append(DepthwiseSeparable(s(in_c), c1, c2, stride, scale))
        self.blocks = nn.Sequential(*blocks)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(s(1024), num_classes)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            from ...tensor.manipulation import flatten

            x = self.fc(flatten(x, 1))
        return x


class InvertedResidual(nn.Layer):
    def __init__(self, in_c, out_c, stride, expand_ratio):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        hidden = int(round(in_c * expand_ratio))
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(in_c, hidden, 1))
        layers += [
            ConvBNLayer(hidden, hidden, 3, stride=stride, padding=1,
                        groups=hidden),
            ConvBNLayer(hidden, out_c, 1, act=None),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = int(32 * scale)
        features = [ConvBNLayer(3, in_c, 3, stride=2, padding=1)]
        for t, c, n, s in cfg:
            out_c = int(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    in_c, out_c, s if i == 0 else 1, t))
                in_c = out_c
        self.last_c = int(1280 * max(1.0, scale))
        features.append(ConvBNLayer(in_c, self.last_c, 1))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(self.last_c, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            from ...tensor.manipulation import flatten

            x = self.classifier(flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return MobileNetV2(scale=scale, **kwargs)

"""Static-graph (fluid-style) flagship model builders.

Copy of ``paddle_tpu/vision/static_models.py`` (the JAX package's
module imports no JAX); the program it builds is the same, op for op.

Role parity: the reference ships fluid ResNet/SE-ResNeXt/Transformer
builders as distributed-test workloads (e.g.
python/paddle/fluid/tests/unittests/dist_se_resnext.py,
dist_transformer.py) and benchmarks them via book-style programs.  These
builders produce the same networks as `paddle_tpu.vision.models` but as
ProgramDesc graphs for the compiled Executor path — the configuration the
BASELINE.json flagship benchmarks measure.
"""
from __future__ import annotations

from .. import layers


def _conv_bn(x, ch, k, stride=1, act=None, name=None):
    conv = layers.conv2d(
        x, ch, k, stride=stride, padding=(k - 1) // 2, bias_attr=False,
        name=None if name is None else name + "_conv")
    return layers.batch_norm(conv, act=act,
                             name=None if name is None else name + "_bn")


def _bottleneck(x, ch, stride, downsample, name):
    """ResNet v1.5 bottleneck: 1x1 -> 3x3(stride) -> 1x1(4*ch) + shortcut."""
    y = _conv_bn(x, ch, 1, act="relu", name=name + "_a")
    y = _conv_bn(y, ch, 3, stride=stride, act="relu", name=name + "_b")
    y = _conv_bn(y, ch * 4, 1, act=None, name=name + "_c")
    if downsample:
        x = _conv_bn(x, ch * 4, 1, stride=stride, act=None, name=name + "_ds")
    return layers.elementwise_add(x, y, act="relu")


def resnet(img, depth=50, class_num=1000):
    """ResNet-{50,101,152} trunk on an NCHW image variable -> logits."""
    cfg = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
    chans = [64, 128, 256, 512]

    y = _conv_bn(img, 64, 7, stride=2, act="relu", name="res_conv1")
    y = layers.pool2d(y, 3, "max", 2, pool_padding=1)
    for stage, (n_blocks, ch) in enumerate(zip(cfg, chans)):
        for blk in range(n_blocks):
            stride = 2 if stage > 0 and blk == 0 else 1
            y = _bottleneck(y, ch, stride, downsample=(blk == 0),
                            name=f"res{stage + 2}{chr(97 + blk)}")
    y = layers.pool2d(y, global_pooling=True, pool_type="avg")
    logits = layers.fc(y, class_num, name="res_fc")
    return logits


def resnet50_train_program(batch_size=None, class_num=1000, lr=0.1,
                           momentum=0.9, img_shape=(3, 224, 224),
                           uint8_input=False):
    """Build (main, startup, feeds, loss) for a ResNet-50 training step.

    Matches BASELINE.json config 2/4 (ResNet-50 ImageNet, SGD+momentum).
    ``uint8_input`` moves image normalization ONTO the device: the feed
    is raw uint8 (4x less host->device bandwidth — the input-pipeline
    bench mode) and a cast+scale at the program head does the rest,
    fused into the first conv by XLA.
    """
    from ..framework.program import Program, program_guard
    from ..optimizer import MomentumOptimizer

    main, startup = Program(), Program()
    with program_guard(main, startup):
        if uint8_input:
            raw = layers.data("image", list(img_shape), dtype="uint8")
            img = layers.scale(layers.cast(raw, "float32"), 1.0 / 127.5,
                               bias=-1.0, bias_after_scale=True)
            img.shape = tuple(raw.shape)
        else:
            img = layers.data("image", list(img_shape))
        label = layers.data("label", [1], dtype="int64")
        logits = resnet(img, depth=50, class_num=class_num)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        opt = MomentumOptimizer(lr, momentum)
    return main, startup, (img, label), loss, opt

"""batchnorm_layers_roofline.train: the least time of a training step's
trunk BatchNorm on the card over the device time a step of the kernels
named episodic_bn_*, in percent, counted over the trunk's BatchNorm layers;
None where none ran, or where the trunk's reference lists no BatchNorm
shapes.

The least time: each trunk BatchNorm's training step must at least read x
and write y forward, then read dy and x and write dx backward, 10 bytes an
element in bf16, at the card's memory rate. Elements a step: the step's
images times the sum of channels x height x width over the trunk's
BatchNorms (reference/trunk_<model>.py::bn_shapes), so that a convolution
that feeds no BatchNorm, as ResNet50's projection shortcuts, counts
nothing."""
import re

from dkt_bench import flops
from dkt_bench.reference.dkt import trunk

KERNELS = re.compile(r"\bepisodic_bn_\w+")
BYTES_PER_ELEMENT = 10


def read(r):
    if r.mode != "train":
        return None
    shapes = getattr(trunk(r.cfg["model"]), "bn_shapes", None)
    t = sum(s for name, s, _ in r.kernels if KERNELS.search(name))
    if shapes is None or t <= 0:
        return None
    images = r.traffic["episode_batch"] * flops.episode_points(r.traffic)
    per_image = sum(c * h * w for c, h, w in shapes(r.cfg["image_size"]))
    bound = images * per_image * BYTES_PER_ELEMENT / flops.PEAK_BYTES
    return 100.0 * bound * r.units / t

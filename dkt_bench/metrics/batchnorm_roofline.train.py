"""batchnorm_roofline.train: the least time of a training step's trunk
BatchNorm on the card over the device time a step of the kernels named
episodic_bn_*, in percent; None where none ran.

The least time: every convolution of the trunks feeds a BatchNorm, whose
training step must at least read x and write y forward, then read dy and x
and write dx backward, 10 bytes an element in bf16, at the card's memory
rate. Elements a step: the step's images times the sum over the
convolutions of out channels x out height x out width."""
import re

from dkt_bench import flops
from dkt_bench.reference.dkt import trunk

KERNELS = re.compile(r"\bepisodic_bn_\w+")
BYTES_PER_ELEMENT = 10


def read(r):
    if r.mode != "train":
        return None
    t = sum(s for name, s, _ in r.kernels if KERNELS.search(name))
    if t <= 0:
        return None
    images = r.traffic["episode_batch"] * flops.episode_points(r.traffic)
    per_image = sum(cout * h * w for _, cout, _, h, w in
                    trunk(r.cfg["model"]).conv_shapes(r.cfg["image_size"]))
    bound = images * per_image * BYTES_PER_ELEMENT / flops.PEAK_BYTES
    return 100.0 * bound * r.units / t

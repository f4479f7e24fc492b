"""Global configuration: a copy of deep_kernel_transfer_tpu/configs.py
(reference configs.py:1-7). kernel_type keeps the default 'bncossim' and
is also the CLI flag --kernel_type."""
import os

save_dir = "./save/"
data_dir = {
    "CUB": "./filelists/CUB/",
    "miniImagenet": "./filelists/miniImagenet/",
    "omniglot": "./filelists/omniglot/",
    "emnist": "./filelists/emnist/",
    "QMUL": "./filelists/QMUL/",
}
kernel_type = os.environ.get("DKT_KERNEL_TYPE", "bncossim")
# linear, rbf, spectral (regression only), matern, poli1, poli2, cossim, bncossim

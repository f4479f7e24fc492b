"""CLI argument surface: a copy of deep_kernel_transfer_tpu/io_utils.py
:15-116 (reference io_utils.py:17-64), the same flags and defaults, so a
command line of the JAX package's train.py, test.py, train_regression.py
or test_regression.py runs the port's `python -m
deep_kernel_transfer_tpu_torch.train`, `.save_features`, `.test`,
`.train_regression` or `.test_regression` unchanged. Flags the port does not serve yet raise in the entry
points (factory.py), not here.
"""
from __future__ import annotations

import argparse


def parse_args(script: str, argv=None):
    parser = argparse.ArgumentParser(description=f"few-shot script {script}")
    parser.add_argument("--seed", default=0, type=int,
                        help="Seed. Default: 0 (None)")
    parser.add_argument("--dataset", default="CUB",
                        help="CUB/miniImagenet/cross/omniglot/cross_char")
    parser.add_argument("--model", default="Conv4",
                        help="model: Conv{4|6} / ResNet{10|18|34|50|101}")
    parser.add_argument("--method", default="baseline",
                        help="baseline/baseline++/DKT/protonet/matchingnet/"
                             "relationnet{_softmax}/maml{_approx}")
    parser.add_argument("--train_n_way", default=5, type=int,
                        help="class num to classify for training")
    parser.add_argument("--test_n_way", default=5, type=int,
                        help="class num to classify for testing (validation)")
    parser.add_argument("--n_shot", default=5, type=int,
                        help="number of labeled data in each class, same as n_support")
    parser.add_argument("--train_aug", action="store_true",
                        help="perform data augmentation during training")
    # additions of the JAX package
    parser.add_argument("--kernel_type", default=None,
                        help="GP kernel for DKT (default: configs.kernel_type)")
    parser.add_argument("--episode_batch", default=1, type=int,
                        help="episodes per device step (vmapped batch)")
    parser.add_argument("--device_data", default="auto",
                        choices=["auto", "on", "off"],
                        help="stage the whole split in device memory and "
                             "sample episodes on the device (see "
                             "data/device_dataset.py). auto = enabled when "
                             "the split fits the 4 GB budget")
    parser.add_argument("--n_devices", default=None, type=int,
                        help="devices in the episode-parallel mesh (default all)")
    parser.add_argument("--feature_dtype", default="bfloat16",
                        help="trunk compute dtype: bfloat16 (default) or "
                             "float32 (exact parity)")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of the first "
                             "training epoch into this directory")

    if script == "train":
        parser.add_argument("--num_classes", default=200, type=int,
                            help="total number of classes in softmax, only used in baseline")
        parser.add_argument("--save_freq", default=50, type=int, help="Save frequency")
        parser.add_argument("--start_epoch", default=0, type=int, help="Starting epoch")
        parser.add_argument("--stop_epoch", default=-1, type=int, help="Stopping epoch")
        parser.add_argument("--resume", action="store_true",
                            help="continue from previous trained model with largest epoch")
        parser.add_argument("--warmup", action="store_true",
                            help="continue from baseline, neglected if resume is true")
        parser.add_argument("--n_train_episodes", default=100, type=int,
                            help="episodes per training epoch (reference "
                                 "fixes 100, data/datamgr.py:69)")
    elif script == "save_features":
        parser.add_argument("--split", default="novel", help="base/val/novel")
        parser.add_argument("--save_iter", default=-1, type=int,
                            help="save feature from the model trained in x epoch, "
                                 "use the best model if x is -1")
    elif script == "test":
        parser.add_argument("--split", default="novel", help="base/val/novel")
        parser.add_argument("--save_iter", default=-1, type=int,
                            help="saved feature from the model trained in x epoch, "
                                 "use the best model if x is -1")
        parser.add_argument("--adaptation", action="store_true",
                            help="further adaptation in test time or not")
        parser.add_argument("--repeat", default=5, type=int,
                            help="Repeat the test N times with different seeds "
                                 "and take the mean. The seeds range is [seed, seed+repeat]")
        parser.add_argument("--n_iter", default=600, type=int,
                            help="test episodes per repeat")
        parser.add_argument("--laplace", action="store_true",
                            help="use the Laplace-approximation GP classifier head (DKT)")
    else:
        raise ValueError("Unknown script")

    return parser.parse_args(argv)


def parse_args_regression(script: str, argv=None):
    parser = argparse.ArgumentParser(description=f"few-shot script {script}")
    parser.add_argument("--seed", default=0, type=int,
                        help="Seed. Default: 0 (None)")
    parser.add_argument("--model", default="Conv3", help="model: Conv{3} / MLP{2}")
    parser.add_argument("--method", default="DKT", help="DKT / transfer")
    parser.add_argument("--dataset", default="QMUL", help="QMUL / sines")
    parser.add_argument("--spectral", action="store_true",
                        help="Use a spectral covariance kernel function")
    parser.add_argument("--task_batch", default=1, type=int,
                        help="1 = one optimizer step per person, in order "
                             "(the reference); any other value = one step "
                             "on the mean over all the people")

    if script == "train_regression":
        parser.add_argument("--start_epoch", default=0, type=int, help="Starting epoch")
        parser.add_argument("--stop_epoch", default=100, type=int, help="Stopping epoch")
        parser.add_argument("--resume", action="store_true",
                            help="continue from previous trained model with largest epoch")
    elif script == "test_regression":
        parser.add_argument("--n_support", default=5, type=int,
                            help="Number of points on trajectory to be given "
                                 "as support points")
        parser.add_argument("--n_test_epochs", default=10, type=int,
                            help="How many test people?")
    return parser.parse_args(argv)

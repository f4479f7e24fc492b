"""Episodic data (port of deep_kernel_transfer_tpu/data): filelists, host
transforms, the device-resident split and the on-device augmentation."""

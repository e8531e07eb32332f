"""Dataset registry: by-name dynamic class lookup (port of
nlt_tpu/datasets/__init__.py)."""

from importlib import import_module


def get_dataset_class(name):
    mod = import_module("nlt_tpu_torch.datasets." + name)
    return mod.Dataset

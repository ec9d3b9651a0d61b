"""Datasets by the conf's ``dataset_name`` (reference
``datasets/normal_datasets/__init__.py:4-7``)."""

from typing import Callable, Dict

from vf_nerf_torch.datasets.base import BaseDataset
from vf_nerf_torch.datasets.replica import ReplicaDataset
from vf_nerf_torch.datasets.scannet import ScanNetDataset
from vf_nerf_torch.datasets.synthetic import (SyntheticBoxDataset,
                                              SyntheticOfficeDataset)

dataset_dict: Dict[str, Callable[..., BaseDataset]] = {
    "replica": ReplicaDataset,
    "scannet": ScanNetDataset,
    "synthetic": SyntheticBoxDataset,
    "synthetic_office": SyntheticOfficeDataset,
}

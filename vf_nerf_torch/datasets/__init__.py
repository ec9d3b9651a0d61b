"""Datasets by the conf's ``dataset_name`` (reference
``datasets/normal_datasets/__init__.py:4-7``).

The Replica and ScanNet loaders read 8-bit colour frames and 16-bit depth
PNGs; their reader is not ported yet (``ROADMAP.md`` A.1), so those names
raise ``NotImplementedError``. The synthetic scenes need no files.
"""

from typing import Callable, Dict

from vf_nerf_torch.datasets.base import BaseDataset
from vf_nerf_torch.datasets.synthetic import (SyntheticBoxDataset,
                                              SyntheticOfficeDataset)


def _not_ported(name: str) -> Callable[..., BaseDataset]:
    def make(config=None, **kwargs) -> BaseDataset:
        raise NotImplementedError(
            f"the {name} loader is not ported to vf_nerf_torch yet: it needs "
            "a reader for its colour frames and 16-bit depth PNGs "
            "(ROADMAP.md A.1); train on 'synthetic' or 'synthetic_office'")
    return make


dataset_dict: Dict[str, Callable[..., BaseDataset]] = {
    "replica": _not_ported("replica"),
    "scannet": _not_ported("scannet"),
    "synthetic": SyntheticBoxDataset,
    "synthetic_office": SyntheticOfficeDataset,
}

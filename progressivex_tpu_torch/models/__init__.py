"""Model families. This slice registers the homography and fundamental
families; the others arrive with their slices."""

from progressivex_tpu_torch.models.base import ModelFamily, get_family, register_family
from progressivex_tpu_torch.models.fundamental import FUNDAMENTAL
from progressivex_tpu_torch.models.homography import HOMOGRAPHY

__all__ = ["ModelFamily", "get_family", "register_family", "FUNDAMENTAL", "HOMOGRAPHY"]

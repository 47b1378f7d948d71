"""Model families: homography, fundamental, essential matrix, 2D line,
vanishing point and 6D pose (PnP)."""

from progressivex_tpu_torch.models.base import ModelFamily, get_family, register_family
from progressivex_tpu_torch.models.essential import ESSENTIAL
from progressivex_tpu_torch.models.fundamental import FUNDAMENTAL
from progressivex_tpu_torch.models.homography import HOMOGRAPHY
from progressivex_tpu_torch.models.line2d import LINE2D
from progressivex_tpu_torch.models.pnp import PNP
from progressivex_tpu_torch.models.vanishing_point import VANISHING_POINT

__all__ = ["ModelFamily", "get_family", "register_family", "ESSENTIAL", "FUNDAMENTAL",
           "HOMOGRAPHY", "LINE2D", "PNP", "VANISHING_POINT"]

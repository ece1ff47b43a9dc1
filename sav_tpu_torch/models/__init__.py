"""sav_tpu_torch.models"""

from sav_tpu_torch.models.factory import (available_models, create_model,  # noqa: F401
                                          set_int8_core, set_use_kernel)
from sav_tpu_torch.models.botnet import BoTNet  # noqa: F401
from sav_tpu_torch.models.ceit import CeiT  # noqa: F401
from sav_tpu_torch.models.cvt import CvT  # noqa: F401
from sav_tpu_torch.models.tnt import TNT  # noqa: F401

"""The refining stage's models (port of detzero_tpu/models/refining):
importing the package registers GRM, PRM and CRM in REFINE_MODULES."""

from detzero_tpu_torch.models.refining.crm import (  # noqa: F401
    ConfidencePointNet, crm_decode, crm_loss,
)
from detzero_tpu_torch.models.refining.grm import (  # noqa: F401
    GeometryTransformer, grm_decode, grm_loss,
)
from detzero_tpu_torch.models.refining.prm import (  # noqa: F401
    PositionTransformer, prm_decode, prm_loss,
)

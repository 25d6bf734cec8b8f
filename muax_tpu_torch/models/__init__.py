"""Network families, the loss, the optimizer, the fused learner and
parameter conversion."""

from muax_tpu_torch.models.networks import (
    MZNetworks,
    MZParams,
    make_mlp_networks,
)
from muax_tpu_torch.models.convert import mlp_params_from_numpy
from muax_tpu_torch.models.losses import LossMetrics, muzero_loss
from muax_tpu_torch.models.optimizers import muzero_optimizer

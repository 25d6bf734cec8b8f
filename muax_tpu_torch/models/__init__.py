"""Network families (Stochastic MuZero's five nets among them), the
losses, the optimizer, the fused learner and
parameter conversion."""

from muax_tpu_torch.models.networks import (
    MZNetworks,
    MZParams,
    make_mlp_networks,
)
from muax_tpu_torch.models.acme_networks import (
    CategoricalMZNetworks,
    make_categorical_mlp_networks,
    make_fc_resnet_networks,
)
from muax_tpu_torch.models.stochastic_networks import (
    SMZNetworks,
    SMZParams,
    make_stochastic_mlp_networks,
)
from muax_tpu_torch.models.convert import (mlp_params_from_numpy,
                                           smz_params_from_numpy)
from muax_tpu_torch.models.losses import LossMetrics, muzero_loss
from muax_tpu_torch.models.stochastic_losses import (SMZLossMetrics,
                                                     stochastic_muzero_loss)
from muax_tpu_torch.models.optimizers import muzero_optimizer

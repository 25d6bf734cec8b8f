"""Network families (the conv triplets, Stochastic MuZero's and Diffusion
MuZero's five nets and the AlphaZero nets among them), the flow library,
the env models, the losses, the optimizers, the fused learner and parameter
conversion."""

from muax_tpu_torch.models.networks import (
    ConvMZNetworks,
    MZNetworks,
    MZParams,
    ResidualConvBlock,
    make_efficientzero_networks,
    make_mlp_networks,
    make_resnet_networks,
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
from muax_tpu_torch.models.diffusion import (
    RectifiedFlow,
    SDE,
    batch_add,
    batch_mul,
    flow_matching_loss,
)
from muax_tpu_torch.models.diffusion_networks import (
    DMZNetworks,
    DMZParams,
    make_diffusion_mlp_networks,
)
from muax_tpu_torch.models.convert import (az_params_from_numpy,
                                           conv_grads_to_numpy,
                                           conv_params_from_numpy,
                                           dmz_params_from_numpy,
                                           env_model_params_from_numpy,
                                           mlp_params_from_numpy,
                                           smz_params_from_numpy)
from muax_tpu_torch.models.losses import LossMetrics, muzero_loss
from muax_tpu_torch.models.stochastic_losses import (SMZLossMetrics,
                                                     stochastic_muzero_loss)
from muax_tpu_torch.models.diffusion_losses import (DMZLossMetrics,
                                                    diffusion_muzero_loss)
from muax_tpu_torch.models.optimizers import (create_optimizer,
                                              flatten_optimizer,
                                              muzero_optimizer)
from muax_tpu_torch.models.az_networks import (AZNetwork, AZParams,
                                               make_az_mlp, make_az_resnet)
from muax_tpu_torch.models.env_model import (
    EnvModel,
    ModelSearchParams,
    env_model_loss,
    make_mlp_transition_model,
    make_model_policy_fn,
    make_model_recurrent_fn,
    make_model_update_fn,
    make_simulator_policy_fn,
    make_simulator_recurrent_fn,
    model_replay_add,
    model_replay_init,
    model_replay_sample,
)

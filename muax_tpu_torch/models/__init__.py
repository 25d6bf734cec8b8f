"""Network families and parameter conversion."""

from muax_tpu_torch.models.networks import (
    MZNetworks,
    MZParams,
    make_mlp_networks,
)
from muax_tpu_torch.models.convert import mlp_params_from_numpy

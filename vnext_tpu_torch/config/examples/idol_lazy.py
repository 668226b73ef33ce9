# Example lazy (python-file) config for IDOL-R50 at configs/idol/ytvis19_r50.yaml's
# widths, loadable with vnext_tpu_torch.tools.lazyconfig_train_net or
# vnext_tpu_torch.config.LazyConfig.load. train.entry trains it with that yaml
# file's recipe through the port's plain loop.
import os

import torch

from vnext_tpu_torch.config import LazyCall
from vnext_tpu_torch.models.idol import IDOL
from vnext_tpu_torch.tools.lazyconfig_train_net import YamlTrainEntry

_CONFIGS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "configs")

model = LazyCall(IDOL)(
    num_classes=40,
    hidden_dim=256,
    num_queries=300,
    enc_layers=6,
    dec_layers=6,
    dtype=torch.bfloat16,
)

train = {
    "output_dir": "./output/idol_lazy",
    "max_iter": 12000,
    "seed": 0,
    "entry": LazyCall(YamlTrainEntry)(config_file=os.path.join(_CONFIGS, "idol", "ytvis19_r50.yaml")),
}

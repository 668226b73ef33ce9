from .model_zoo import (
    get,
    get_checkpoint_url,
    get_config,
    get_config_file,
    list_configs,
    resolve_checkpoint,
)

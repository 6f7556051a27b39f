"""Configuration of the port."""

from .config import (CfgNode, file_task, get_cfg_defaults, load_config,
                     update_eval_data, update_from, update_opt)

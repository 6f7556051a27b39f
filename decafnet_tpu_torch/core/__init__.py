"""Configuration of the port."""

from .config import (CfgNode, diff_dict, file_task, generate_expname,
                     get_cfg_defaults, get_task, load_config, setup_cfg,
                     update_eval_data, update_from, update_opt)

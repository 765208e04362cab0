from .defaults import Config, get_cfg_defaults, feat_dim_for

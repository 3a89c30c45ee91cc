"""Server-side updater stack: default, sgd, adagrad, momentum, adam and
ftrl, each a pure function on tensors (see ``updaters.py``)."""

from multiverso_tpu_torch.updaters.updaters import (AddOption, Updater,
                                                    get_updater,
                                                    register_updater,
                                                    resolve_default_option,
                                                    updater_names)

__all__ = ["AddOption", "Updater", "get_updater", "register_updater",
           "resolve_default_option", "updater_names"]

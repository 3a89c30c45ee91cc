"""Host-only utilities carried over from ``multiverso_tpu/utils``: flags,
logging, the prefetch iterator."""

from multiverso_tpu_torch.utils import async_buffer, configure, log
from multiverso_tpu_torch.utils.async_buffer import prefetch_iterator
from multiverso_tpu_torch.utils.configure import (define_bool, define_float,
                                                  define_int, define_string,
                                                  describe_flags, get_flag,
                                                  has_flag, parse_flags,
                                                  reset_flags, set_flag)

__all__ = [
    "async_buffer", "configure", "log", "prefetch_iterator",
    "define_bool", "define_float", "define_int", "define_string",
    "describe_flags", "get_flag", "has_flag", "parse_flags", "reset_flags",
    "set_flag",
]

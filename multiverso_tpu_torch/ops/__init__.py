"""Kernels of the port: hand-written CUDA for Hopper, each beside its
plain PyTorch version (see ``table_kernels.py`` and ``lda_sampler.py``)."""

from multiverso_tpu_torch.ops import lda_sampler, table_kernels
from multiverso_tpu_torch.ops.lda_sampler import (gibbs_sample_docblock,
                                                  gibbs_sample_docblock_build,
                                                  gibbs_sample_tiled)
from multiverso_tpu_torch.ops.table_kernels import (coo_scatter_add,
                                                    coo_scatter_add_masked,
                                                    gather_rows,
                                                    row_scatter_add,
                                                    row_scatter_add_masked)

__all__ = ["coo_scatter_add", "coo_scatter_add_masked", "gather_rows",
           "gibbs_sample_docblock", "gibbs_sample_docblock_build",
           "gibbs_sample_tiled", "lda_sampler", "row_scatter_add",
           "row_scatter_add_masked", "table_kernels"]

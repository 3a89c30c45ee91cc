"""The data layer: corpus, vocabulary, Huffman codes and example
generation on the host (the native C++ backend; the Python one for
tests)."""

from multiverso_tpu_torch.data.corpus import (Corpus, backend,
                                             default_gen_threads,
                                             synthetic_docs, synthetic_text)
from multiverso_tpu_torch.data.corpus_data import CorpusData
from multiverso_tpu_torch.data.native import (ABI_VERSION, CHUNK_SEED_STEP,
                                             NativeData, load_native)
from multiverso_tpu_torch.data.pydata import PyData

__all__ = ["ABI_VERSION", "CHUNK_SEED_STEP", "Corpus", "CorpusData",
           "NativeData", "PyData", "backend", "default_gen_threads",
           "load_native", "synthetic_docs", "synthetic_text"]

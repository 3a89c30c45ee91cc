"""The data layer: corpus, vocabulary, Huffman codes and example
generation on the host (Python backend)."""

from multiverso_tpu_torch.data.corpus import (Corpus, synthetic_docs,
                                             synthetic_text)
from multiverso_tpu_torch.data.corpus_data import CorpusData
from multiverso_tpu_torch.data.pydata import PyData

__all__ = ["Corpus", "CorpusData", "PyData", "synthetic_docs",
           "synthetic_text"]

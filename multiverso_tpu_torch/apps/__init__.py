"""Applications on the port's tables (word2vec in this slice)."""

"""Tokenizer, alignment-state helpers, TM-align and FASTA datasets and
batching (own copies of the numpy-only parts of ``deepblast_tpu.data``)."""

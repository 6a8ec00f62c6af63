"""Tokenizer, alignment-state helpers and FASTA input (own copies of the
numpy-only parts of ``deepblast_tpu.data`` the serving path needs)."""

"""Tokenizers, alignment-state helpers, TM-align, Malidup and FASTA
datasets and batching, PDB and corpus parsers, secondary structure and
substitution matrices (own copies of the numpy-only parts of
``deepblast_tpu.data``)."""

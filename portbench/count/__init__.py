"""Work counts as functions of shapes, valid lengths and storage types:
the operations a model's forward and backward need (:mod:`.model`) and
the bytes and transcendentals the alignment DP needs (:mod:`.dp`), and
the chip's peaks (:mod:`.peaks`).  They never read a kernel's source or
its compiled code: they count the least work the mathematics needs, so a
share of a peak that they give cannot pass 100% for a correct program."""

"""Language models, embedding heads and the neural aligner."""

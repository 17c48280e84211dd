"""The plain reference: BERT with mean pooling and L2 norm, its tokenizer,
exact top-k, MNRL and AdamW, in plain PyTorch at float32 with TF32 off.

It imports nothing of the program and takes nothing the program made: the
benchmark hands it the texts, the vocab, the weights it made from the seed,
and the dropout seeds; it reads the program's outputs only to judge them.
"""

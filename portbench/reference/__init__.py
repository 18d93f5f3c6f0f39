"""The plain reference: the benchmark's configurations written from their
published descriptions in plain PyTorch, float32 throughout.

It imports nothing of the program under test.  It receives the weights
and token batches the benchmark made from the seed, in the program's tree
layout (a dict of tensors, the layers stacked on a leading axis), and
works out everything else again: the forward pass, the loss, the
gradients, the clipping and the AdamW update.

``precision`` names the arithmetic of every matrix product: ``"fp32"``
(the reference, TF32 off) or ``"fp8"`` (the control: each operand scaled
by its own absolute maximum into float8 e4m3's range, rounded there, and
multiplied in float32), the precision one step below the configurations'
bfloat16.
"""

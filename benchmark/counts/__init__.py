"""Operations and bytes of the functions the program computes, from shapes.

Frozen yardstick: a later change to the program does not change what a
call or a model is counted as, so a kernel fused, split or re-tiled is
still counted by the function it computes.  Bytes count each input read
once and each output written once.
"""

"""The Pegasos stage (``csrc/pegasos_stage.cu``, kernels ``stage_small`` and
``stage_wide``) against its roofline: (2d + 2) operations a live row and
step of the instances not yet latched, or its bytes."""

from portbench.metrics import _roofline


def read(run):
    return _roofline.share(run, "pegasos_stage",
                           ("stage_small", "stage_wide"))

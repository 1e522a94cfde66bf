# Hand-written CUDA kernels (csrc/, built by _build.py) for the engine's
# dominant primitives, their plain PyTorch versions (ref.py), and the
# dispatch policy (dispatch.py) that routes query-pipeline call sites
# between the two. ops.py is the explicit-choice API. Importing this
# package compiles and loads nothing: kernels build at first launch.
from repro_torch.kernels import dispatch, ops, ref  # noqa: F401

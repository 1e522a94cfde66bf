"""Back-compat alias of the port's LLM prefill/decode launcher,
``repro_torch.launch.serve_model`` (the reference keeps the same shim: the
SQL query-serving layer is ``repro_torch.core.serve``). ``python -m
repro_torch.launch.serve`` runs it; new code should use ``serve_model``.
"""
from repro_torch.launch.serve_model import main

__all__ = ["main"]

if __name__ == "__main__":
    main()

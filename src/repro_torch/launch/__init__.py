"""Launchers of the port: ``serve_model`` (batched LLM prefill + greedy
decode) and its ``serve`` alias. Training, the mesh and the dry run are
not ported yet (ROADMAP.md A16)."""

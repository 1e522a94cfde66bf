"""Launchers of the port: ``serve_model`` (batched LLM prefill + greedy
decode) and its ``serve`` alias, ``train`` (end-to-end training over the
engine-selected corpus), ``mesh`` (device meshes and the production
topologies as shapes), ``hlo_cost`` (FLOPs, bytes and collective bytes of
recorded aten ops) and ``dryrun`` (every arch x shape cell traced on the
meta device)."""

"""Batched LLM serving through the PyTorch port: prefill + greedy decode
with KV / SSM-state caches, on the card. (SQL query serving is
examples/torch_serving_demo.py.)

    PYTHONPATH=src python examples/torch_serve_batched.py --arch qwen2_1p5b
    PYTHONPATH=src python examples/torch_serve_batched.py --arch zamba2_1p2b --cpu

The twin of ``examples/serve_batched.py``: a batch of requests through
``repro_torch.launch.serve_model`` on the arch's smoke config. SSM and
hybrid archs decode with O(1) state per sequence.
"""
import sys
import time

from repro_torch.launch.serve_model import main as serve_main


def main(argv=None):
    """Returns the generated ids ([batch, gen] int32)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    t0 = time.perf_counter()
    if "--cpu" in argv:
        argv = [a for a in argv if a != "--cpu"] + ["--device", "cpu"]
    if not any(a.startswith("--arch") for a in argv):
        argv = ["--arch", "qwen2_1p5b"] + argv
    if "--smoke" not in argv:
        argv.append("--smoke")
    ids = serve_main(argv)
    print(f"wall {time.perf_counter() - t0:.2f}s")
    print("serve_batched example OK")
    return ids


if __name__ == "__main__":
    main()

"""HTTP model-server entry point: checkpoint, state_dict or exported
artifact -> endpoint.

Counterpart of dostransformer_tpu/cli/main_serve.py, the network-facing
counterpart of main_predict, with the port's ``--device`` (the card by
default; with no card visible the run stops unless ``--device cpu``):

    # from a training checkpoint (one featurized sample gives the input
    # widths):
    python -m dostransformer_tpu_torch.cli.main_serve \
        --task phdos --checkpoint_dir ckpt/ --example data.npz --port 8000

    # from a main_predict --export artifact (no model flags needed):
    python -m dostransformer_tpu_torch.cli.main_serve \
        --from_exported artifact/ --port 8000

Protocol: POST /predict with a data/io.py samples npz body returns an npz
{dos, sample_id, mp_id}; GET /healthz returns JSON. See serve_http.py. On the
card every request is served through the predictor's CUDA graphs
(serve_dispatch.py). ``DOSTPU_FUSE_LN_ATTN=1`` in the environment serves a
checkpoint through the LN-fused attention kernel, as main_predict does.
"""

from __future__ import annotations

import argparse
import os

from dostransformer_tpu_torch.cli.main_predict import (
    check_sources,
    load_predictor,
)

# where the ROADMAP brings the JAX flag the port does not have yet
_DATA_PARALLEL = "queue 1 item 9 (parallelism)"


def build_server(argv=None):
    """Parse args and return the configured (unstarted) HTTP server."""
    p = argparse.ArgumentParser("dostpu-torch-serve")
    p.add_argument("--task", choices=["edos", "phdos"],
                   help="required unless --from_exported")
    p.add_argument("--checkpoint_dir",
                   help="training checkpoint to serve (or --from_exported)")
    p.add_argument("--example",
                   help="featurized samples .npz giving the input widths "
                        "(required with --checkpoint_dir and "
                        "--torch_state_dict)")
    p.add_argument("--from_exported", metavar="DIR",
                   help="serve a main_predict --export artifact (ignores the "
                        "model-shape flags)")
    p.add_argument("--torch_state_dict", metavar="PATH",
                   help="serve a torch.save'd state_dict (reference or port "
                        "naming; model-shape flags must match the weights; "
                        "needs --example)")
    p.add_argument("--embedder", default="DOSTransformer")
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--transformer", type=int, default=2)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--data_parallel", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--checkpoint_state", choices=["best", "latest"],
                   default=None,
                   help="'best' (default) serves the best-validation model "
                        "(<dir>/best, falling back to latest when absent); "
                        "'latest' serves the newest cadence checkpoint")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--coalesce_ms", type=float, default=0.0,
                   help="micro-batch concurrent requests into one predictor "
                        "call, waiting up to this many ms for stragglers "
                        "(0 = off)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; with no card visible "
                        "the run stops unless --device cpu is given)")
    args = p.parse_args(argv)

    if args.data_parallel:
        p.error(f"--data_parallel is not in the PyTorch port yet; see "
                f"ROADMAP.md {_DATA_PARALLEL}")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # HTTP serving is request-driven: a request landing on one process
        # would enter a collective predict alone while its peers idle in
        # serve_forever — a distributed deadlock, not an error
        p.error("multi-process HTTP serving is not supported: requests "
                "would deadlock the job's collectives. Serve single-process "
                "(one server per card, a load balancer in front)")
    check_sources(p, args)
    if not (args.from_exported or (args.task and args.example and (
            args.checkpoint_dir or args.torch_state_dict))):
        p.error("--task, --example and --checkpoint_dir (or "
                "--torch_state_dict) are required unless --from_exported "
                "is given")

    from dostransformer_tpu_torch.data.io import load_samples
    from dostransformer_tpu_torch.device import cli_device
    from dostransformer_tpu_torch.serve_http import make_server

    device = cli_device(p, args.device)
    example = None if args.from_exported else load_samples(args.example)[0]
    predictor = load_predictor(args, example, device)
    return make_server(predictor, host=args.host, port=args.port,
                       coalesce_ms=args.coalesce_ms)


def main(argv=None):
    server = build_server(argv)
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port}  "
          f"(POST /predict, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        # drains the CoalescingBatcher (queued requests resolve before the
        # process exits) and closes the listening socket
        server.server_close()


if __name__ == "__main__":
    main()

"""The port's serving entry point against the reference's, on the CPU.

Both serve the reduced llama3-8b with the same orchestration
substrate; the summaries (latency priced by the cost model, decisions, wire
bytes, compression ratio, final split) must be equal.
"""

import pytest
import torch

from repro.launch import serve as jax_serve
from repro_torch.launch import serve


@pytest.mark.parametrize("argv", [
    ["--requests", "4", "--compress"],
    ["--requests", "5", "--prompt-len", "48", "--backhaul-mbps", "20"],
])
def test_serve_summary_equals_reference(argv):
    ref = jax_serve.main(argv)
    out = serve.main(argv + ["--device", "cpu"])
    assert out == ref


def test_serve_counts_transfers_and_runs_bf16_params():
    out, engine = serve.run(serve.parse_args(
        ["--requests", "3", "--compress", "--device", "cpu",
         "--param-dtype", "bfloat16"]))
    stats = engine.transfer_stats()
    # the initial split (0, 1, 2, 4) has two boundaries; no re-split here
    assert out["final_split"] == "(0, 1, 2, 4)"
    assert stats.transfers == 3 * 2
    assert engine.params["embed"].dtype == torch.bfloat16


def test_serve_requires_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the cuda default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--requests", "1"])

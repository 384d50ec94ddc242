"""deft_tpu_torch's Tracer (obs/tracing.py), the port of deft_tpu
obs/tracing.py over torch.profiler, and the CLI's --trace-dir.

- Tracer(None): no profiler, no file, spans and annotated functions run;
- a session writes one Chrome trace holding each span by name;
- ``--trace-dir`` writes a trace of the run that names the prefill,
  plan_build and decode_step spans of tree_generate.
"""

import json

import torch

from deft_tpu_torch.cli import run
from deft_tpu_torch.obs import Tracer


def test_no_op_tracer(tmp_path):
    tracer = Tracer(None)
    with tracer.session():
        with tracer.span("decode_step"):
            x = torch.ones(4) + 1
    assert tracer.trace_file is None and not list(tmp_path.iterdir())
    assert tracer.annotate_fn("f", lambda a, b=0: a + b)(2, b=3) == 5
    assert float(x.sum()) == 8.0


def test_span_lands_in_the_trace(tmp_path):
    tracer = Tracer(str(tmp_path / "traces"))
    f = tracer.annotate_fn("annotated_fn", lambda t: t @ t)
    with tracer.session():
        with tracer.span("my_span"):
            f(torch.ones(8, 8))
    events = json.loads(open(tracer.trace_file).read())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"my_span", "annotated_fn"} <= names


def test_cli_trace_dir_writes_decode_steps(tmp_path, capsys):
    out = tmp_path / "trace"
    assert run.main(["--device", "cpu", "--random-model", "tiny", "--max_width", "2",
                     "--max_seq_len", "24", "--dtype", "float32", "--kv_pool_slots",
                     "4096", "--trace-dir", str(out)]) == 0
    assert "trace written to" in capsys.readouterr().out
    files = list(out.glob("*.json"))
    assert len(files) == 1
    names = [e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]]
    assert names.count("prefill") == 1
    assert names.count("decode_step") == names.count("plan_build") > 1

"""The three per-layer metrics of the Kimi-VL cell on synthetic records:
``moe_ms_per_step.train`` (device ms of the program's ``moe.block`` spans a
step), ``moe_gemm_roofline_pct.train`` and ``mla_attn_fwd_roofline_pct.train``
(a bound of the step's work over the device time of the kernels each names);
each reads nothing where its cell gives it nothing (a program without the
spans, a trace without the kernels, a window without steps)."""

import pytest

from benchmark.lib import program_spans, registry
from benchmark.lib.trace import Record

MS = 1_000_000
WINDOW = (500 * MS, 10_500 * MS)
MLA = "void mimic::mma::mla_attn_fwd_mma_kernel<true, mimic::mma::CfgQV<192, 128, 2, 2, 1> >"
D128 = "void mimic::mma::attn_fwd_mma_kernel<128, true, mimic::mma::CfgT<128, 2, 2, 1> >"
GEMM = ("void cutlass::device_kernel<at::cuda::detail::enable_3x_kernel_for_sm9x<"
        "cutlass::gemm::kernel::GemmUniversal<cutlass::gemm::GroupProblemShape<...> > > >")
PREP = "void at::cuda::detail::prepare_grouped_gemm_data<cutlass::bfloat16_t>(...)"


def record(work, ops=()):
    """A window of 10 s with device operations (name, start ms, end ms)."""
    device_ops = [(n, WINDOW[0] + int(s * MS), WINDOW[0] + int(e * MS)) for n, s, e in ops]
    return Record(device_ops=device_ops, host_spans=[("window", *WINDOW)], window_s=10.0,
                  busy_s=sum(e - s for _, s, e in ops) / 1e3, work=work)


def read(name, rec):
    return registry.metric_reader(name).read(rec)


def spans(*items):
    out = []
    for i, (name, start, dev) in enumerate(items):
        out.append(dict(name=name, id=i, parent=None, root=i, start_ns=WINDOW[0] + start * MS,
                        end_ns=WINDOW[0] + (start + 1) * MS, host_ms=1.0, device_ms=dev,
                        self_device_ms=dev, self_host_ms=1.0))
    return out


def test_moe_ms_per_step(monkeypatch):
    prog = {"spans": spans(("moe.block", 10, 4.0), ("moe.route", 10, 1.0),
                           ("moe.block", 20, 6.0), ("moe.block", 30, 5.0)),
            "counts": {"moe_assignments": 600}}
    monkeypatch.setattr(program_spans, "program", lambda: prog)
    rec = record({"steps": 3})
    assert read("moe_ms_per_step.train", rec) == pytest.approx(5.0)
    # a span before the window, from an earlier recording, is left out
    prog["spans"].append(dict(prog["spans"][0], start_ns=0, end_ns=1))
    assert read("moe_ms_per_step.train", rec) == pytest.approx(5.0)
    assert read("moe_ms_per_step.train", record({"steps": 0})) is None
    monkeypatch.setattr(program_spans, "program", lambda: {"spans": [], "counts": {}})
    assert read("moe_ms_per_step.train", rec) is None  # a program without the spans
    monkeypatch.setattr(program_spans, "program", lambda: None)
    assert read("moe_ms_per_step.train", rec) is None  # a program without the recorder


def test_mla_attn_fwd_roofline_reads_its_own_kernel_only():
    work = {"steps": 2, "mla_attn_fwd_bound_s": 0.003, "attn_fwd_bound_s": 0.009}
    rec = record(work, [(MLA, 0, 2), (MLA, 5, 7), (D128, 8, 9)])
    assert read("mla_attn_fwd_roofline_pct.train", rec) == pytest.approx(75.0)
    # the shared metric reads both instantiations (their names hold its substring)
    assert read("attn_fwd_roofline_pct.train", rec) == pytest.approx(180.0)
    assert read("mla_attn_fwd_roofline_pct.train", record(work, [(D128, 0, 1)])) is None
    assert read("mla_attn_fwd_roofline_pct.train", record({"steps": 2}, [(MLA, 0, 1)])) is None


def test_moe_gemm_roofline_reads_the_grouped_products():
    rec = record({"steps": 1, "moe_gemm_bound_s": 0.0035},
                 [(GEMM, 0, 4), (PREP, 4, 4.1), (GEMM, 5, 5.9), ("elementwise_kernel", 6, 9)])
    assert read("moe_gemm_roofline_pct.train", rec) == pytest.approx(350 / 5.0)
    assert read("moe_gemm_roofline_pct.train", record({"steps": 1, "moe_gemm_bound_s": 1.0},
                                                      [(D128, 0, 1)])) is None


def test_the_cell_lists_its_metrics():
    spec = registry.benchmark_spec()
    cell = "kimi-vl-a3b.mimic-train-8shot"
    got = {m["name"] for m in registry.cell_metrics(spec, cell)["per_layer"]}
    assert {"moe_ms_per_step.train", "moe_gemm_roofline_pct.train",
            "mla_attn_fwd_roofline_pct.train", "mfu.train", "attn_fwd_roofline_pct.train",
            "attn_bwd_roofline_pct.train", "host_syncs_per_step.train"} <= got
    ends = {m["name"] for m in registry.cell_metrics(spec, cell)["end_to_end"]}
    assert ends == {"train_samples_per_s", "setup_s"}

"""ResNet-50 training images/s on one card, after the other two
north-star lines — the port of ``bench.py``: the same program
(``resnet_imagenet(depth=50)``, 1000 classes, ``mean(cross_entropy)``,
``Momentum(0.01, 0.9)``, bf16 mixed precision), the same synthetic feed
(``RandomState(0)``, resident on the card), the same rounds, the same
environment knobs and the same JSON keys.

    python -m paddle_tpu_torch.benchmarks.resnet

Without ``BENCH_RESNET_ONLY`` it first runs ``benchmarks.lm`` and
``benchmarks.nmt`` as child processes (``bench.py``'s
``_run_secondary_benches``: only ``BENCH_ITERS``, ``BENCH_ROUNDS``,
``BENCH_WARMUP`` and ``BENCH_FORCE_CPU`` of the ``BENCH_*`` knobs reach
them), forwards each child's last JSON line, and prints the ResNet line
last with both folded in as ``submetrics``.

Then, as ``bench.py`` does by default, the fp8 storage recipe, set only
now so that it scopes to the ResNet run: ``PADDLE_TPU_FP8_ACTS=1`` (relu
outputs stored as e4m3) unless ``BENCH_FP8_ACTS=0``, and
``PADDLE_TPU_FP8_CONV_OUT`` from ``BENCH_FP8_CONV_OUT`` (``e5m2`` by
default; ``0`` or empty disables it, ``1`` is e4m3, ``scaled`` and
``delayed`` the per-tensor scaled modes). The step is
``Executor.run_steps(n_steps=ITERS, return_numpy=False)`` — on the card
one captured CUDA graph, replayed — after the warm dispatches; each
timed round syncs once, through its ``FetchHandle``, and the median
round is the headline. On the card cuDNN picks its convolution
algorithms by timing them (``cudnn.benchmark``), as XLA autotunes the
reference's convolutions.

Knobs (environment): BENCH_BATCH (256), BENCH_WARMUP (steps, rounded up
to whole ITERS-step dispatches; 3), BENCH_ITERS (100), BENCH_ROUNDS (3),
BENCH_LAYOUT (NHWC or NCHW), BENCH_FP8_ACTS (1), BENCH_FP8_CONV_OUT
(e5m2), BENCH_RESNET_ONLY. ``BENCH_FORCE_CPU=1`` runs on the CPU; without
it a machine with no card gets the failure JSON line and exit 1.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

METRIC = "resnet50_train_images_per_sec_per_chip"
UNIT = "images/sec"
# the reference tree's only published ResNet-50 training number (MKL-DNN
# fp32, batch 128, 2S Xeon 6148; benchmark/IntelOptimizedPaddle.md:41-45)
BASELINE_IMG_PER_SEC = 82.35
BATCH = int(os.environ.get("BENCH_BATCH", 256))
WARMUP = int(os.environ.get("BENCH_WARMUP", 3))
ITERS = int(os.environ.get("BENCH_ITERS", 100))
ROUNDS = int(os.environ.get("BENCH_ROUNDS", 3))
AMP = True  # bf16 compute, fp32 master weights
LAYOUT = os.environ.get("BENCH_LAYOUT", "NHWC").upper()
assert LAYOUT in ("NCHW", "NHWC"), "BENCH_LAYOUT must be NCHW or NHWC"
# the model (bench.py's, fixed there): depth, image side, classes
DEPTH, IMAGE, CLASSES = 50, 224, 1000
LR, MOMENTUM = 0.01, 0.9

# the secondary benches, as child commands run from the repo root, and
# the knobs that reach them
SECONDARY = (("lm", [sys.executable, "-m", "paddle_tpu_torch.benchmarks.lm"]),
             ("nmt", [sys.executable, "-m",
                      "paddle_tpu_torch.benchmarks.nmt"]))
FORWARDED = ("BENCH_ITERS", "BENCH_ROUNDS", "BENCH_WARMUP", "BENCH_FORCE_CPU")
SECONDARY_TIMEOUT_S = 900
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def fp8_recipe():
    """Set the fp8 storage environment from ``BENCH_FP8_ACTS`` and
    ``BENCH_FP8_CONV_OUT`` (``bench.py:51-62``); returns (fp8_acts,
    conv-out mode, "0" when off)."""
    fp8_acts = os.environ.get("BENCH_FP8_ACTS", "1") != "0"
    if fp8_acts:
        os.environ["PADDLE_TPU_FP8_ACTS"] = "1"
    fp8_conv = os.environ.get("BENCH_FP8_CONV_OUT", "e5m2")
    if fp8_acts and fp8_conv not in ("", "0"):
        os.environ["PADDLE_TPU_FP8_CONV_OUT"] = fp8_conv
    else:
        fp8_conv = "0"
    return fp8_acts, fp8_conv


def precision(fp8_acts, fp8_conv):
    """``bench.py``'s precision string."""
    if not AMP:
        return "fp32"
    if not fp8_acts:
        return "bf16"
    if fp8_conv == "0":
        return "bf16+fp8-acts"
    return "bf16+fp8-acts+fp8-convout-%s" % ("e4m3" if fp8_conv == "1"
                                              else fp8_conv)


def build_program(*, depth=None, image=None, classes=None, layout=None):
    """``bench.py``'s program: (prog, startup, loss). The sizes default
    to DEPTH, IMAGE, CLASSES and LAYOUT (a test passes smaller ones)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import models
    image = IMAGE if image is None else image
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        images = fluid.layers.data(name="images", shape=[3, image, image],
                                   dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        pred = models.resnet_imagenet(
            images, class_dim=CLASSES if classes is None else classes,
            depth=DEPTH if depth is None else depth,
            data_format=LAYOUT if layout is None else layout)
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        fluid.optimizer.Momentum(learning_rate=LR, momentum=MOMENTUM) \
            .minimize(loss)
    fluid.enable_mixed_precision(prog, AMP)
    return prog, startup, loss


def make_feed(batch, image, classes):
    """``bench.py``'s fake data from ``RandomState(0)``: images, then
    labels, as numpy."""
    rng = np.random.RandomState(0)
    return {"images": rng.rand(batch, 3, image, image).astype(np.float32),
            "label": rng.randint(0, classes, (batch, 1)).astype(np.int64)}


def _measure_rounds(exe, prog, loss, feed):
    """The warm dispatches (``WARMUP`` steps rounded up to whole
    ``ITERS``-step dispatches, synced once after the last), then
    ``ROUNDS`` timed ones, each synced through its ``FetchHandle``.
    Returns (the timed rounds' seconds, the last handle)."""
    lv = None
    for _ in range(-(-WARMUP // ITERS) if WARMUP > 0 else 0):
        lv = exe.run_steps(prog, feed=feed, n_steps=ITERS,
                           fetch_list=[loss], return_numpy=False)
    if lv is not None:
        lv.numpy()
    round_dts = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        lv = exe.run_steps(prog, feed=feed, n_steps=ITERS,
                           fetch_list=[loss], return_numpy=False)
        lv.numpy()
        round_dts.append(time.perf_counter() - t0)
    return round_dts, lv


def main():
    """The secondary benches, then the ResNet rounds; prints the JSON
    line and returns it as a dict (with the rounds' seconds and the step
    FLOPs under ``_``-keys)."""
    import torch
    import paddle_tpu_torch as fluid
    from ..flops import device_peak_flops, estimate_program_flops
    from .common import place

    submetrics = _run_secondary_benches()
    fp8_acts, fp8_conv = fp8_recipe()
    prog, startup, loss = build_program()
    step_flops = estimate_program_flops(prog, BATCH, training=True)

    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(place())
        feed = {k: torch.as_tensor(v).to(exe.device)
                for k, v in make_feed(BATCH, IMAGE, CLASSES).items()}
        on_card = exe.device.type == "cuda"
        old_benchmark = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = on_card or old_benchmark
        try:
            exe.run(startup)
            round_dts, lv = _measure_rounds(exe, prog, loss, feed)
            exe.close()
        finally:
            torch.backends.cudnn.benchmark = old_benchmark

    med_dt = statistics.median(round_dts)
    img_per_sec = BATCH * ITERS / med_dt
    peak = device_peak_flops() if on_card else None
    mfu = step_flops * ITERS / med_dt / peak if peak else None
    rates = sorted(BATCH * ITERS / dt for dt in round_dts)
    line = {
        "metric": METRIC,
        "value": round(img_per_sec, 2),
        "unit": UNIT,
        "vs_baseline": round(img_per_sec / BASELINE_IMG_PER_SEC, 3),
        "mfu": round(mfu, 4) if mfu is not None else None,
        "layout": LAYOUT,
        "batch": BATCH,
        "iters": ITERS,
        "rounds": ROUNDS,
        "spread_img_s": [round(rates[0], 2), round(rates[-1], 2)],
        "step_tflops": round(step_flops / 1e12, 3),
        "precision": precision(fp8_acts, fp8_conv),
        "loss": round(float(lv.numpy()[0].ravel()[0]), 4),
        "submetrics": submetrics,
    }
    print(json.dumps(line))
    line["_round_s"] = round_dts
    line["_step_flops"] = step_flops
    return line


def _run_secondary_benches():
    """Run the LM and NMT benches as child processes (``SECONDARY``),
    forward each one's last JSON line to stdout, and fold their
    ``metric``/``value``/``unit``/``mfu``/``error`` into the returned
    ``submetrics``; a child that times out, crashes or prints nothing
    is recorded as that entry's ``error``. Skipped under
    ``BENCH_RESNET_ONLY``."""
    subs = {}
    if os.environ.get("BENCH_RESNET_ONLY"):
        return subs
    # the recipe's knobs (BENCH_BATCH, BENCH_FP8_*) stay with ResNet; the
    # pacing and backend ones reach the children, so a BENCH_ITERS=2
    # smoke run does not start their full rounds
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_") or k in FORWARDED}
    for name, cmd in SECONDARY:
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=SECONDARY_TIMEOUT_S, cwd=REPO,
                               env=env)
            tail = [ln for ln in r.stdout.splitlines() if ln.strip()]
            if tail:
                parsed = json.loads(tail[-1])
            else:
                err = (r.stderr or "").strip().splitlines()[-3:]
                parsed = {"error": "rc=%d, no stdout; stderr tail: %s"
                          % (r.returncode, " | ".join(err))}
        except subprocess.TimeoutExpired:
            parsed = {"error": "timeout after %ds" % SECONDARY_TIMEOUT_S}
        except Exception as e:  # noqa: BLE001 - the line records it
            parsed = {"error": "%s: %s" % (type(e).__name__, e)}
        print(json.dumps(parsed), flush=True)
        subs[name] = {k: parsed.get(k) for k in
                      ("metric", "value", "unit", "mfu", "error")
                      if k in parsed}
    return subs


if __name__ == "__main__":
    from .common import run_guarded
    run_guarded(main, METRIC, UNIT, extra={"layout": LAYOUT, "batch": BATCH})

"""Quickstart: the paper in 60 seconds, through the port's one front door.

A hypergraph partition IS an SpGEMM algorithm — and ``repro_torch.plan`` is
the whole pipeline: model the instance, partition it, lower the cut to
routing tables, and run the partition on the card.  The port stacks all p
ranks on one device (``distributed.comm.Loopback``), so the product runs
wherever the device exists, at any p.

  PYTHONPATH=src python examples_torch/quickstart.py                 # on the card
  PYTHONPATH=src python examples_torch/quickstart.py --device cpu    # plain PyTorch
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

import repro_torch
from repro_torch._device import resolve_device

A_FIG1 = np.array([[1, 0, 1, 0], [1, 0, 0, 1], [0, 1, 0, 0]])
B_FIG1 = np.array([[0, 1], [1, 0], [1, 1], [0, 1]])


def fig1() -> None:
    print("== Fig. 1 instance, fine-grained model (Def. 3.1) ==")
    fig1 = repro_torch.plan(A_FIG1, B_FIG1, p=2, model="fine", name="fig1", include_nz=True)
    inst = fig1.instance
    print(f"S_A nnz={inst.a.nnz}, S_B nnz={inst.b.nnz}, S_C nnz={inst.c.nnz}, "
          f"|V^m|={inst.n_mult}")
    print(f"hypergraph: {fig1.hypergraph}")


def plan_every_model(inst, p: int) -> dict:
    """One symbolic inspection, seven plans; prints the cost table and
    returns the handles by model."""
    print(f"\n== one real instance, every model, p={p} ==")
    print(f"{'model':12s} {'family':>6s} {'exec':>5s} {'predicted':>9s} "
          f"{'planned':>9s} {'maxpart':>8s}  imb")
    handles = {}
    for model in repro_torch.MODELS:
        handle = handles[model] = repro_torch.plan(inst, p=p, model=model)
        r = handle.cost_report()
        print(
            f"{model:12s} {handle.spec.family:>6s} {str(r['executable']):>5s} "
            f"{r['predicted_words']:9d} {r['planned_words']:9d} "
            f"{r['predicted_max_part']:8d}  {r['comp_imbalance']:.2f}"
        )
    return handles


def run(inst, p: int = 4, device=None) -> dict:
    """Fig. 1, the seven plans of ``inst``, and ``model="auto"`` executed on
    ``device`` (the card unless named).  Returns the handles by model
    (``"auto"`` among them), the executed product and its operands."""
    device = resolve_device(device)
    fig1()
    handles = plan_every_model(inst, p)

    print("\n== auto-selection + execution (values in, dense C out) ==")
    rng = np.random.default_rng(0)
    spgemm = handles["auto"] = repro_torch.plan(inst, p=p, model="auto")
    print(f"selected model: {spgemm.model} "
          f"(predicted {spgemm.cost_report()['predicted_words']} words)")
    a_s, b_s = inst.a, inst.b
    a_vals = rng.standard_normal(a_s.nnz).astype(np.float32)
    b_vals = rng.standard_normal(b_s.nnz).astype(np.float32)
    dense_a = np.zeros(a_s.shape, np.float32)
    dense_a[a_s.coo()] = a_vals
    dense_b = np.zeros(b_s.shape, np.float32)
    dense_b[b_s.coo()] = b_vals
    c = spgemm.compile(device=device)(a_vals, b_vals).cpu().numpy()
    err = float(np.abs(c - dense_a @ dense_b).max())
    print(f"executed {spgemm.p} ranks on {device}: max |C - A@B| = {err:.2e}")
    return {"handles": handles, "c": c, "a": dense_a, "b": dense_b, "max_abs_err": err}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    from repro_torch.core.matrices import mcl_instance

    return run(mcl_instance("dip", scale=0.2), p=4, device=args.device)


if __name__ == "__main__":
    main()

"""Drive the port's solvers on a gloo mesh of CPU ranks and dump what each
run leaves behind, for tests/test_torch_parallel.py.

Usage: python tests/torch_mesh_ranks.py <dp|tp> <dir>

``<dir>`` holds the configs the test wrote (train.yaml, test.yaml). ``dp``
starts a 2 x 1 mesh, ``tp`` a 2 x 2 one, through the port's own launcher
(``parallel/mesh.py launch``). Each rank runs one thread, as the
single-process reference does, so the runs differ only by the mesh. On
every rank: the real ASR solver for 3 steps, then the same run with a
planted fault; rank 0 writes each run's gathered parameters to
``<dir>/params_<run>.pt``, every rank the shapes of its own leaves to
``<dir>/shapes_<case>_<rank>.json``. ``dp`` also decodes with the test
solver (its CSVs land in ``<dir>/out``).
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from e2e_asr_pytorch_tpu_torch import main as M  # noqa: E402
from e2e_asr_pytorch_tpu_torch.convert import (tree_leaves,  # noqa: E402
                                                tree_map)
from e2e_asr_pytorch_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402

CASES = {"dp": (2, 1), "tp": (2, 2)}


def _argv(d, name, *extra):
    return ["--config", os.path.join(d, "train.yaml"), "--name", name,
            "--cpu", "--njobs", "0", "--no-msg", "--logdir",
            os.path.join(d, "log"), "--ckpdir", os.path.join(d, "ckpt"),
            "--outdir", os.path.join(d, "out")] + list(extra)


def _fault_avg(mesh_cls):
    """DDP's default: each rank's loss over its own weights, the gradients
    averaged over the data ranks."""
    plain = mesh_cls.reduce_grads

    def reduce_grads(self, grads, specs):
        return tree_map(lambda g: g / self.n_data,
                        plain(self, grads, specs))
    return {"global_sum": lambda self, x: x.detach().float(),
            "reduce_grads": reduce_grads}


def _fault_noreduce(mesh_cls):
    """Each rank steps on its own rows' gradient."""
    def reduce_grads(self, grads, specs):
        return tree_map(lambda g, s: self.shard(g) if s == mesh_lib.SHARDED
                        else g, grads, specs)
    return {"reduce_grads": reduce_grads}


def _fault_order(mesh_cls):
    """The 'model' slices joined in reversed rank order."""
    def _gather_model(self, x):
        parts = [torch.empty_like(x) for _ in range(self.n_model)]
        torch.distributed.all_gather(parts, x.contiguous(),
                                     group=self.model_group)
        return torch.cat(parts[::-1], dim=-1)
    return {"_gather_model": _gather_model}


FAULTS = {"dp": {"avg": _fault_avg, "noreduce": _fault_noreduce},
          "tp": {"order": _fault_order}}


def _dump(solver, d, run):
    params = solver.full_params()
    if solver.is_writer:
        torch.save(params, os.path.join(d, "params_{}.pt".format(run)))


def worker(case, d):
    torch.set_num_threads(1)
    mesh = mesh_lib.current()
    flags = ["--n-devices", str(mesh.world_size), "--n-model",
             str(mesh.n_model)]
    solver = M.run(_argv(d, case) + flags)
    _dump(solver, d, case)
    shapes = {"params": [list(x.shape) for x in tree_leaves(solver.params)],
              "opt": {k: [list(x.shape) for x in tree_leaves(v)]
                      for k, v in solver.opt_state.items()
                      if k != "count"}}
    with open(os.path.join(d, "shapes_{}_{}.json".format(
            case, mesh.rank)), "w") as f:
        json.dump(shapes, f)
    for name, fault in FAULTS[case].items():
        patch = fault(mesh_lib.Mesh)
        saved = {k: getattr(mesh_lib.Mesh, k) for k in patch}
        for k, v in patch.items():
            setattr(mesh_lib.Mesh, k, v)
        try:
            _dump(M.run(_argv(d, case + "_" + name, "--override",
                              "hparas.valid_step=100") + flags), d,
                  case + "_" + name)
        finally:
            for k, v in saved.items():
                setattr(mesh_lib.Mesh, k, v)
    if case == "dp":
        M.run(["--test", "--config", os.path.join(d, "test.yaml"),
               "--name", "dec_dp", "--cpu", "--njobs", "0", "--no-msg",
               "--outdir", os.path.join(d, "out")] + flags)


if __name__ == "__main__":
    case, d = sys.argv[1], sys.argv[2]
    n_data, n_model = CASES[case]
    mesh_lib.launch(n_data, n_model, True, worker, case, d)
    print("torch_mesh_ranks done", case, flush=True)

"""Same-call A/B of the training CLI's loader on the flagship preset.

    python3 chip_loader_ab.py

From the repository root, on one card. It writes phase 16's four trees at
1024^2 (``chip_smoke.write_flagship_tree``) and runs the 13B training CLI
on them four times, alternating the two ways of making each row's random
draws: "new", in the loader's own thread in row order
(``HybridDataset.plan``, what the CLI does), and "old", in the worker
thread that builds the row, after the mixture's pick (the loader before
the draws moved out of the workers). Prints the card and one JSON line a
run: the CLI's seconds, the first batch's, each step's seconds less its
wait for the batch, the waits and each step's rows by task."""
import gc
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from interactvlm_tpu_torch.data import datasets as D  # noqa: E402


def draws_in_worker(self):
    return lambda: (lambda p: p[0].plan(p[1])())(self.pick())


if __name__ == "__main__":
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    c._cuda.build()
    work = os.path.join(c.WORKDIR, "flagship_ab")
    files = c.write_flagship_inputs(os.path.join(work, "inputs"), c.SPHERE,
                                    c.DAMON_IMAGES, c.PICO_SPHERES,
                                    c.PIAD_POINTS, c.PIAD_OBJECTS)
    tree = os.path.join(work, "tree_1024")
    c.write_flagship_tree(tree, files, c.MASK, c.DAMON_IMAGES)
    new = D.HybridDataset.plan
    for i, side in enumerate(["old", "new", "new", "old"]):
        D.HybridDataset.plan = draws_in_worker if side == "old" else new
        argv = c.FLAG_PRESET + [
            "--model_scale", "full", "--tokenizer", "whitespace",
            "--dataset_dir", tree, "--data_workers", str(c.FLAG_WORKERS),
            "--epochs", "1", "--steps_per_epoch", str(c.FLAG_STEPS),
            "--batch_size", str(c.FLAG_B), "--no_eval", "--save_every", "9",
            "--log_base_dir", os.path.join(work, f"runs{i}"),
            "--no_tensorboard"]
        trainer, cli_s, *_ = c.cli_train(argv)
        print(json.dumps({"side": side, "cli_s": cli_s,
                          "first_batch_s": trainer.first_batch_s,
                          "step_s": [h["batch_s"] - h["data_s"]
                                     for h in trainer.history],
                          "data_s": [h["data_s"] for h in trainer.history],
                          "rows": [h["rows_by_task"]
                                   for h in trainer.history]}), flush=True)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

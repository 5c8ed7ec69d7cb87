"""The worker of ``tests/test_torch_dist_train.py``'s spawns: one
``lightgbm_torch.distributed.run`` call runs every configuration of its
``args`` in one process per rank (gloo, CPU), so that the start-up is
paid once.  It imports torch and the port only."""

import numpy as np


def run_cells(ctx, args):
    import torch
    torch.set_num_threads(1)
    import lightgbm_torch as lgt
    from lightgbm_torch import distributed

    x, y = args["x"], args["y"]
    xv, yv = args["xv"], args["yv"]
    R, r = ctx.num_workers, ctx.rank
    out = {}
    for name, params, opts in args["configs"]:
        p = dict(params, device_type="cpu")
        rounds = opts.get("rounds", 5)
        kw = {}
        if opts.get("api"):
            def fit():
                return distributed.train(p, x, y, num_boost_round=rounds,
                                         valid=(xv, yv))
        else:
            full = lgt.Dataset(x, label=y, params=p).construct()
            idx = np.arange(len(x)) if p["tree_learner"] == "feature" \
                else np.array_split(np.arange(len(x)), R)[r]

            def fit():
                ds = lgt.Dataset(x[idx], label=y[idx], params=p,
                                 bin_mappers=full.bin_mappers)
                if opts.get("valid"):
                    kw["valid_sets"] = [lgt.Dataset(xv, label=yv, params=p,
                                                    reference=ds)]
                return lgt.train(p, ds, num_boost_round=rounds, **kw)
        bst = fit()
        m = bst._model
        res = {"text": bst.model_to_string(),
               "best_iteration": bst.best_iteration,
               "rows": m.num_data, "row_offset": m.row_offset,
               "dist": m.dist,
               "calls": dict(m.dist_grower.comm.calls)}
        if opts.get("rerun"):
            res["rerun"] = fit().model_to_string()
        if opts.get("bag"):
            res["masks"] = [m._bagging_w(it).numpy() for it in range(3)]
        out[name] = res
    return out

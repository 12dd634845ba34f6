"""pairs_per_view.train: the mean of the steps' ``n_pairs`` counter per
camera view over the traced window, the pairs the binning hands the
compositor."""


def read(ctx):
    return ctx.get("pairs_per_view")

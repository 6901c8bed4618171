"""CoAE's operations and its RoIAlign kernel's bytes, from shapes, by the
rules of counts/flops.py: each multiply-add of a convolution or a matrix
product two operations, elementwise work (BatchNorm, ReLU, the gate's
products, softmax) not counted; a kernel's bytes each input byte read once
and each output byte written once, fp32.

A CoAE eval request (models/coae.py) runs, per image, the backbone and the
scene's 1x1 convolutions phi_ and g, and per (image, query) pair the
co-attention (f, its two products, W and Q), the gate's MLP, the RPN's
three convolutions, layer4 over the pair's RoIs and over its query map, and
the predictors. The queries' own backbone pass and theta, g are the class
bank's, built once in set-up.
"""

from __future__ import annotations

from .flops import backbone_flops, conv_flops, feature_map, half_up, level_sizes

LAYER4_OUT = 2048


def layer4_flops(config, h, w):
    """torchvision's layer4 (v1.5) on one h x w map of feature_dim channels."""
    width, c = config["layer4_width"], config["feature_dim"]
    ho, wo = half_up(h), half_up(w)
    total = (conv_flops(c, width, 1, h, w) + conv_flops(width, width, 3, ho, wo)
             + conv_flops(width, 4 * width, 1, ho, wo) + conv_flops(c, 4 * width, 1, ho, wo))
    for _ in range(config["layer4_blocks"] - 1):
        total += (conv_flops(4 * width, width, 1, ho, wo) + conv_flops(width, width, 3, ho, wo)
                  + conv_flops(width, 4 * width, 1, ho, wo))
    return total


def anchors_per_cell(config):
    return len(config["anchor_scales"]) * len(config["anchor_ratios"])


def attention_flops(config, scene_hw, query_hw):
    """The co-attention and the gate of one pair: f = theta(a)^T phi_(x), the
    two products with g, W on the query's map, Q on the scene's, the MLP on
    both pools."""
    f, inter = config["feature_dim"], config["inter_channels"]
    n_d, n_a = scene_hw[0] * scene_hw[1], query_hw[0] * query_hw[1]
    hidden = f // config["gate_reduction"]
    return (3 * 2 * n_a * n_d * inter + conv_flops(inter, f, 1, *query_hw)
            + conv_flops(inter, f, 1, *scene_hw) + 2 * 2 * 2 * f * hidden)


def rpn_flops(config, scene_hw):
    f, rpn, a = config["feature_dim"], config["rpn_channels"], anchors_per_cell(config)
    return (conv_flops(f, rpn, 3, *scene_hw) + conv_flops(rpn, 2 * a, 1, *scene_hw)
            + conv_flops(rpn, 4 * a, 1, *scene_hw))


def roi_head_flops(config, query_hw):
    """layer4 over the pair's RoIs (pool x pool) and its query map, the box
    predictor on each RoI, the score's two layers on [r; q]."""
    pool, post = config["pool_size"], config["rpn_post_nms"]
    predictors = 2 * LAYER4_OUT * 4 + 2 * 2 * LAYER4_OUT * 8 + 2 * 8 * 2
    return post * (layer4_flops(config, pool, pool) + predictors) + layer4_flops(config, *query_hw)


def pair_flops(config, scene_hw, query_hw):
    """One (image, query) pair at feature maps scene_hw and query_hw."""
    return (attention_flops(config, scene_hw, query_hw) + rpn_flops(config, scene_hw)
            + roi_head_flops(config, query_hw))


def scene_flops(config, h, w):
    """The backbone on one h x w image and its scene terms phi_, g."""
    fh, fw = feature_map(h, w)
    return backbone_flops(config, h, w) + 2 * conv_flops(config["feature_dim"],
                                                         config["inter_channels"], 1, fh, fw)


def eval_flops_per_image(config, traffic):
    """One image at every level of the mix against its classes."""
    q = traffic["class_image_size"]
    query_hw = feature_map(q, q)
    total = 0
    for w, h in level_sizes(traffic):
        total += scene_flops(config, h, w)
        total += traffic["classes"] * pair_flops(config, feature_map(h, w), query_hw)
    return total


def touched_cells(rois, spatial_scale, h, w):
    """Per RoI (x1, y1, x2, y2 in image pixels) the cells of an h x w map
    that its samples' corners can read: the rows from floor(y1 * s) to
    floor(y2 * s) + 1 and the columns alike, clipped to the map."""
    out = []
    for x1, y1, x2, y2 in rois:
        rows = [min(max(int(v * spatial_scale // 1) + d, 0), h - 1) for v, d in ((y1, 0), (y2, 1))]
        cols = [min(max(int(v * spatial_scale // 1) + d, 0), w - 1) for v, d in ((x1, 0), (x2, 1))]
        out.append(max(rows[1] - rows[0] + 1, 1) * max(cols[1] - cols[0] + 1, 1))
    return out


def roi_align_bytes(pairs, rois_per_pair, h, w, channels, pool, cells=None):
    """The RoIAlign kernel on `pairs` maps of h x w x channels with
    rois_per_pair RoIs each: the output written once, the RoIs read once,
    and per pair each feature byte its RoIs touch read once, at most the
    whole map. cells: per pair the sum of its RoIs' `touched_cells`; None
    takes the whole map (the cap), which the CoAE cell's 300 RoIs a pair
    reach: its smallest anchor spans 12 x 6 cells, 300 of them 21,600 cells
    against the 60 x 80 map's 4,800."""
    per_pair = [h * w] * pairs if cells is None else [min(c, h * w) for c in cells]
    return 4 * (pairs * rois_per_pair * (pool * pool * channels + 5) + channels * sum(per_pair))

from sednet_tpu_torch.fit.primitives import (
    fit_plane,
    fit_sphere,
    fit_cylinder,
    fit_cone,
    ridge_lstsq,
)
from sednet_tpu_torch.fit.residuals import (
    distance_from_plane,
    distance_from_sphere,
    distance_from_cylinder,
    distance_from_cone,
    distance_from_torus,
    residual_loss,
    residual_loss_batched,
)
from sednet_tpu_torch.fit.bspline import (
    uniform_knot_bspline,
    sample_from_control_grid,
    standardize_points,
    reverse_transformation,
    fit_control_points_kronecker,
)
from sednet_tpu_torch.fit.evaluation import (
    Evaluation,
    match,
    p_coverage,
    separate_losses,
    weights_normalize,
)
from sednet_tpu_torch.fit.driver import (
    FittingModule,
    fit_one_shape,
    remove_outliers,
    up_sample_points_in_range,
    optimize_spline_kronecker,
)
from sednet_tpu_torch.fit.samplers import (
    sample_plane,
    sample_sphere,
    sample_cylinder,
    sample_cone,
    sample_torus,
)

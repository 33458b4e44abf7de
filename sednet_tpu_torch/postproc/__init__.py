from sednet_tpu_torch.postproc.robust_fits import (
    RobustFitter,
    circle_segmentation,
    fit_circle_2d,
    rodrigues_rot,
)
from sednet_tpu_torch.postproc.boundary import (
    three_nn_indices,
    boundary_edge_mask,
    bad_points_mask,
    face_adjacency,
)
from sednet_tpu_torch.postproc.inst_cluster import resplit_instances
from sednet_tpu_torch.postproc.intersections import (
    plane_plane,
    plane_cylinder,
    plane_cone,
    plane_sphere,
    cylinder_cone,
    cylinder_sphere,
    line_line_intersection,
    line_circle_intersection,
    intersect,
)
from sednet_tpu_torch.postproc.pipeline import (
    process_shape,
    majority_type_with_priors,
    save_shape_parameters,
)

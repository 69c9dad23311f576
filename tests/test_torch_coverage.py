"""Every test of the JAX package has a port test, or a reason it has none.

``MAP`` names, for each ``test_*`` function of each JAX test file under
tests/ (every ``test_*.py`` but the port's ``test_torch_*.py``), the port
test that holds what it asserts (a node id, on the CPU or the card, or a
list of them where its halves are held apart), or "not ported" with its
reason, quoted from the "Not to port" list of ROADMAP.md. Both sides
are read with ``ast``, nothing is imported: a JAX test with no entry
fails its file's case, so does an entry whose JAX test or port test does
not exist (a bracketed parameter must be a string constant of the port
test's module), and a reason that the list does not hold.
"""

import ast
import functools
import glob
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROADMAP = os.path.join(os.path.dirname(HERE), "ROADMAP.md")


def not_ported(reason):
    return ("not ported", reason)


OOM = not_ported("The OOM degrade ladder (`_oom_degrade`, `_relayout_ss`)")
HBM = not_ported("The TPU HBM model (`estimate_hbm_peak`, `_peak_at_cap`, "
                 "`_enforce_hbm`: `solver.py:662-750,1100-1202`) and the "
                 "`fused_ok` 0.55·HBM gate")
SWEEP_OFF = not_ported("the sweep-off and `pallas_win` rungs of `grow_for`. "
                       "Kernel C has no window, so OVF_BIN_OCC and "
                       "OVF_PALLAS_WIN never rise.")

API = "test_torch_api.py::"
BEH = "test_torch_behaviour.py::"
BODY = "test_torch_jax_bodies.py::"
CUDA = "test_torch_cuda.py::"
FORCE = "test_torch_force.py::"
HOST = "test_torch_host.py::"
LEAF = "test_torch_leaf.py::"
PAR = "test_torch_parallel.py::"
TWO = "test_torch_twoclass.py::"


def same_names(port_file, names):
    return {n: f"{port_file}::{n}" for n in names.split()}


def bodies(names):
    return {n: f"{BODY}test_jax_body_on_port[{n[len('test_'):]}]"
            for n in names.split()}


MAP = {
    "test_adaptive_bin.py": {
        "test_build_grid_factor_scales_and_clamps":
            BODY + "test_build_grid_factor_scales_and_clamps",
        "test_pairs_identical_across_factors":
            BODY + "test_pairs_identical_across_factors",
        "test_setbinsize_sets_factor_and_warns_below_floor":
            API + "test_bin_switches_match_jax",
        "test_adaptive_flag_reaches_engine":
            BODY + "test_adaptive_flag_reaches_engine",
        "test_occupancy_overflow_walks_factor_back": SWEEP_OFF,
        "test_oversized_bin_simulation_matches_floor":
            BEH + "test_oversized_bin_simulation_matches_floor",
        "test_propose_bin_walks_toward_best":
            API + "test_tuner_proposals_match_jax[bin_walk]",
    },
    "test_api_balldrop.py": same_names(
        "test_torch_behaviour.py",
        "test_balldrop_settles test_checkpoint_roundtrip "
        "test_prescribed_motion_family test_family_change_when "
        "test_update_clumps_midsim"),
    "test_api_extras.py": {
        **bodies(
            "test_prescribed_linvel_dictate_false_assigns_then_integrates "
            "test_add_owner_next_step_acc_one_shot "
            "test_change_clump_family_and_purge "
            "test_family_owner_wildcard_and_geometry_wildcards "
            "test_tri_anal_wildcards test_one_time_persistency_and_remove "
            "test_owner_contact_clumps_and_forces "
            "test_disable_family_output test_device_inspectors_match_host "
            "test_get_bin_size_reflects_margins "
            "test_write_contact_file_including_potential_pairs "
            "test_round3_api_stragglers test_set_expand_factor_fixed_margin "
            "test_per_axis_prescriptions_accumulate "
            "test_obj_vn_normals_honored "
            "test_mesh_mass_properties_and_wavefront "
            "test_tracker_plural_and_torque_queries "
            "test_clump_template_csv_and_data_file "
            "test_family_material_reassign_and_duplicate "
            "test_output_formats_roundtrip test_mesh_output_normals_and_obj "
            "test_prescription_merge_keeps_earlier_axes"),
        **same_names("test_torch_behaviour.py",
                     "test_correct_family_lin_vel_additive "
                     "test_correct_family_lin_vel_callable_component"),
        "test_correct_family_quaternion_reseats_base":
            BODY + "test_correct_family_quaternion_reseats_base",
        "test_round3b_api_stragglers": BEH + "test_round3b_api_stragglers",
        "test_resize_keeps_unused_layout_placeholders_empty":
            BODY + "test_resize_keeps_unused_layout_placeholders_empty",
        "test_slim_fused_tables_drop_query_fields_and_fill_on_demand":
            BEH + "test_slim_fused_tables_drop_query_fields_and_fill_on_"
                  "demand",
    },
    "test_auto_freq.py": {
        "test_propose_k_explores_unmeasured_neighbors":
            API + "test_tuner_proposals_match_jax[explore]",
        "test_propose_k_walks_toward_cheapest_rung":
            API + "test_tuner_proposals_match_jax[walk_up]",
        "test_propose_k_respects_user_max_freq":
            API + "test_tuner_proposals_match_jax[max_freq]",
        "test_propose_k_respects_remaining_steps":
            API + "test_tuner_proposals_match_jax[remaining]",
        "test_advance_with_auto_freq_tunes_within_ladder":
            API + "test_tuner_in_advance_replays_jax",
        "test_settle_retune_drops_stale_rungs":
            API + "test_tuner_in_advance_replays_jax",
    },
    "test_custom_force_models.py": {
        "test_electrostatic_repulsion":
            "test_torch_custom.py::test_electrostatic_pair_matches",
        "test_bonded_pair_oscillates_not_escapes":
            BEH + "test_bonded_pair_oscillates_not_escapes",
        "test_bond_breaks_at_high_speed":
            BEH + "test_bond_breaks_at_high_speed",
    },
    "test_engine_clumps_mesh.py": same_names(
        "test_torch_goldens.py",
        "test_dumbbell_settles_flat test_clump_collision_momentum "
        "test_mesh_bounce_restitution"),
    "test_engine_friction_settle.py": same_names(
        "test_torch_goldens.py", "test_slide_to_roll test_settling_bed"),
    "test_engine_log_events.py": {
        "test_engine_log_wired_and_leveled":
            API + "test_engine_log_events[wired]",
        "test_step_metric_level_shows_growth_events":
            API + "test_engine_log_events[step_metric]",
        "test_quiet_silences_everything": API + "test_engine_log_events[quiet]",
    },
    "test_engine_two_spheres.py": same_names(
        "test_torch_goldens.py",
        "test_head_on_restitution test_head_on_frictionless_model "
        "test_no_contact_no_motion test_plane_bounce_restitution "
        "test_head_on_restitution_segment_reduce"),
    "test_examples.py": same_names(
        "test_torch_smokes.py",
        "test_rotating_drum_smoke test_ball_drop_smoke test_wheel_dp_smoke "
        "test_game_of_life_generations test_grc_prep_and_restore"),
    "test_examples_round3.py": same_names(
        "test_torch_smokes.py",
        "test_single_sphere_collide_smoke test_test_pack_smoke "
        "test_contact_chain_smoke test_shake_smoke test_sieve_smoke "
        "test_plow_smoke test_hopper_smoke test_repose2d_smoke "
        "test_ball_drop_2d_smoke test_wheel_slope_slip_smoke "
        "test_wheel_dp_simplified_smoke test_grc_prep_part2_part3_chain "
        "test_flexible_mesh_smoke"),
    "test_examples_round4.py": same_names(
        "test_torch_smokes.py",
        "test_cohesion_reduces_spread test_mooring_chain_holds"),
    "test_flexmesh_checkpoint.py": {
        "test_flexible_mesh_update": BEH + "test_flexible_mesh_update",
        "test_exact_checkpoint_roundtrip":
            API + "test_checkpoint_round_trip_bit_for_bit",
        "test_change_clump_sizes": API + "test_change_clump_sizes_matches_jax",
        "test_solar_system_orbit": BEH + "test_solar_system_orbit",
    },
    "test_history_map.py": same_names(
        "test_torch_host.py",
        "test_merge_match_brute_parity "
        "test_carry_history_persistency_reinject "
        "test_carry_history_lost_sentry_counts_dropped_history"),
    "test_integrators.py": {
        n: "test_torch_families.py::test_integrators_one_step_match_jax"
        for n in ("test_forward_euler_uses_old_velocity",
                  "test_centered_difference_uses_new_velocity",
                  "test_extended_taylor_uses_midpoint_velocity")},
    "test_materials_samplers.py": {
        "test_material_pair_override": BEH + "test_material_pair_override",
        "test_grid_sampler_spacing":
            HOST + "test_sampler_regions_match_jax[GridSampler]",
        "test_hcp_sampler_min_distance": HOST + "test_dem_samplers_match_jax",
        "test_cyl_surf_sampler": HOST + "test_dem_samplers_match_jax",
        "test_sphere_and_cylinder_regions":
            HOST + "test_sampler_regions_match_jax",
    },
    "test_multichip.py": {
        "test_eight_device_mesh_matches_single":
            PAR + "test_sharded_step_matches_jax",
        "test_sharded_step_partitions_big_arrays":
            PAR + "test_step_sizes_are_per_rank",
        # their physics halves, and each rank's sizes in place of the
        # HLO's shapes
        "test_st_sweep_shards_over_mesh": [
            PAR + "test_production_shape",
            PAR + "test_plate_rows_match_jax[st]",
            PAR + "test_refresh_sizes_are_per_rank[tri]"],
        "test_10k_sphere_mesh_walls_parity": [
            PAR + "test_production_shape",
            PAR + "test_refresh_sizes_are_per_rank[tri]"],
    },
    "test_oom_fallback.py": {
        "test_is_device_oom_matcher": OOM,
        "test_refresh_oom_degrades_and_completes": OOM,
        "test_chunk_loop_oom_rewinds_and_degrades": OOM,
        "test_uniq_fetch_dropped_before_fused_pass": OOM,
        "test_relayout_oom_walks_to_next_rung": OOM,
        "test_hbm_gate_degrades_before_dispatch": HBM,
        "test_hbm_gate_dies_politely_when_nothing_left": HBM,
        "test_uniq_gate_priced_by_model": HBM,
        "test_hbm_gate_shrinks_cap_to_admit_uniq": HBM,
        "test_hbm_gate_uniq_admit_churn_guard": HBM,
        "test_hbm_gate_uniq_drop_is_readmitted": HBM,
    },
    "test_pallas_force.py": {
        "test_fused_matches_xla_full_hertz":
            FORCE + "test_fused_step_matches_jax",
        "test_fused_matches_xla_frictionless":
            FORCE + "test_fused_step_matches_jax",
        "test_fused_across_refresh_and_unaligned_cap":
            "test_torch_slice.py::test_refresh_pairs_and_history_carry",
        "test_fused_matches_xla_ratio3_radii":
            "test_torch_mesh.py::test_slice_advance_matches_jax",
        "test_fused_extras_match_xla_across_block_boundaries":
            FORCE + "test_extras_match_jax",
        "test_gather_rows_T_chunked_matches": not_ported(
            "`forces.gather_rows` (i16 bitcast), `gather_rows_T`, and "
            "`DEM_FORCE_NOMATH`."),
        "test_slim_table_has_no_premix": BODY + "test_slim_table_has_no_premix",
    },
    "test_pallas_segred.py": {
        "test_matches_segment_sum_dense":
            "test_torch_segred.py::test_plain_matches_jax_blocks[random]",
        "test_dead_tail_does_not_spill":
            "test_torch_segred.py::test_plain_matches_jax_blocks[dead_tail]",
        "test_sparse_table_spills":
            "test_torch_segred.py::test_v1_plain_matches_jax[sparse_spill]",
    },
    "test_pallas_sweep3.py": {
        "test_v3_matches_xla_dense":
            "test_torch_sweep.py::test_sweep_matches_jax[dense]",
        "test_v3_matches_xla_sparse":
            CUDA + "test_sweep_kernel_edge_tables[sparse]",
        "test_v3_family_mask":
            "test_torch_sweep.py::test_sweep_matches_jax[family_mask]",
        "test_v3_clustered_bins":
            CUDA + "test_sweep_kernel_edge_tables[overfull_bin]",
    },
    "test_quat.py": {
        "test_identity_rotation": LEAF + "test_quat_matches_jax[rotate]",
        "test_axis_angle_90deg_z": LEAF + "test_quat_matches_jax[rotate]",
        "test_rotate_inv_roundtrip": LEAF + "test_quat_matches_jax[rotate_inv]",
        "test_hamilton_composition": LEAF + "test_quat_matches_jax[hamilton]",
        "test_integrate_constant_omega":
            LEAF + "test_quat_matches_jax[integrate]",
        "test_unit_norm_preserved": LEAF + "test_quat_matches_jax[normalize]",
    },
    "test_sentry_and_st.py": {
        "test_lost_contact_sentry_fires":
            BODY + "test_jax_body_on_port[lost_contact_sentry_fires]",
        "test_exact_st_candidate_filter":
            "test_torch_mesh.py::test_exact_st_candidate_filter",
    },
    "test_spatial_refresh.py": {
        "test_spatial_matches_global": PAR + "test_spatial_matches_global",
        "test_spatial_family_mask": PAR + "test_spatial_family_mask",
        "test_spatial_refresh_hlo_partitions_sweep":
            PAR + "test_refresh_sizes_are_per_rank[bed]",
        "test_spatial_end_to_end_matches_global": PAR + "test_production_shape",
        "test_spatial_keeps_escaped_spheres":
            PAR + "test_spatial_keeps_escaped_spheres",
    },
    "test_stage_timers.py": {
        "test_profile_stage_timings_keys_and_print":
            BEH + "test_profile_stage_timings_keys_and_print",
    },
    "test_twoclass_cd.py": {
        "test_twoclass_matches_single_grid":
            TWO + "test_two_class_search_matches[cloud]",
        "test_twoclass_pallas_small_matches":
            TWO + "test_two_class_search_matches",
        "test_twoclass_respects_family_mask":
            TWO + "test_two_class_search_matches[cloud]",
        "test_engine_twoclass_settles":
            TWO + "test_solver_radius_rule_and_single_grid_agree",
        "test_sweep_reenable_probe": SWEEP_OFF,
        "test_twoclass_small_reach_above_large":
            TWO + "test_two_class_search_matches[small_reach_above_large]",
    },
    "test_uniq_fetch.py": {
        "test_uniq_layout_structures": FORCE + "test_uniq_layout_matches_jax",
        "test_uniq_step_matches_direct_fused":
            FORCE + "test_uniq_step_matches_jax",
        "test_uniq_extras_pass_matches_direct":
            FORCE + "test_uniq_step_matches_jax",
        "test_uniq_overflow_flag_and_engine_growth":
            "test_torch_engine.py::test_uniq_overflow_flag_and_engine_growth",
        "test_uniq_survives_capacity_shrink":
            "test_torch_engine.py::test_uniq_survives_capacity_shrink",
    },
    "test_validation_demos.py": same_names(
        "test_torch_validation.py",
        "test_repose_angle_friction_vs_frictionless "
        "test_cone_penetration_resistance_grows "
        "test_centrifuge_pins_particles_to_wall "
        "test_mixer_decorrelates_labels test_fracture_bonds_break_on_impact "
        "test_electrostatic_cluster_expands "
        "test_indentation_bears_and_indents"),
    "test_validation_literature.py": same_names(
        "test_torch_validation.py",
        "test_repose_angle_glass_bead_band "
        "test_ball_drop_depth_scales_with_height_cuberoot "
        "test_drawbar_pull_increases_with_slip"),
    "test_voxel.py": {
        "test_encode_decode_roundtrip_host": LEAF + "test_voxel_matches_jax"
                                                    "[encode]",
        "test_rel_pos_precision_far_from_origin":
            LEAF + "test_voxel_matches_jax[rel_pos]",
        "test_advance_crosses_voxel_boundary":
            LEAF + "test_voxel_matches_jax[advance]",
        "test_advance_many_steps_no_drift":
            LEAF + "test_voxel_matches_jax[advance]",
    },
}


def jax_test_files():
    return sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(HERE, "test_*.py"))
                  if not os.path.basename(p).startswith("test_torch_"))


@functools.lru_cache(maxsize=None)
def _module(name):
    """(top-level test function names, string constants) of a test file
    under tests/."""
    with open(os.path.join(HERE, name)) as f:
        tree = ast.parse(f.read(), name)
    tests = {n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
             and n.name.startswith("test_")}
    consts = {n.value for n in ast.walk(tree)
              if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    return tests, consts


@functools.lru_cache(maxsize=None)
def _not_to_port():
    """ROADMAP.md's "Not to port" list, whitespace joined."""
    with open(ROADMAP) as f:
        text = f.read()
    start = text.index("**Not to port.**")
    end = text.index("\n### ", start)
    return " ".join(text[start:end].split())


def _port_test_exists(node):
    m = re.fullmatch(r"(test_torch_\w+\.py)::(test_\w+)(?:\[([^\]]+)\])?",
                     node)
    if not m or not os.path.exists(os.path.join(HERE, m[1])):
        return False
    tests, consts = _module(m[1])
    return m[2] in tests and (m[3] is None or m[3] in consts
                              or "test_" + m[3] in consts)


@pytest.mark.parametrize("jax_file", jax_test_files())
def test_every_jax_test_has_a_port_test_or_a_reason(jax_file):
    jax_tests, _ = _module(jax_file)
    entries = MAP.get(jax_file, {})
    assert set(entries) == jax_tests, (
        f"{jax_file}: no entry for {sorted(jax_tests - set(entries))}, "
        f"entries for no such test {sorted(set(entries) - jax_tests)}")
    for name, entry in entries.items():
        if isinstance(entry, tuple):
            assert entry[0] == "not ported"
            assert " ".join(entry[1].split()) in _not_to_port(), (
                f"{jax_file}::{name}: the reason is not in ROADMAP.md's "
                f"Not to port list: {entry[1]!r}")
        else:
            for node in [entry] if isinstance(entry, str) else entry:
                assert _port_test_exists(node), (
                    f"{jax_file}::{name}: no port test {node}")


def test_map_names_only_jax_test_files():
    assert set(MAP) <= set(jax_test_files()), sorted(
        set(MAP) - set(jax_test_files()))

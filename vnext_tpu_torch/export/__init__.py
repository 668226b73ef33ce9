from .api import export_program, load_exported, plain_versions_refused, save_exported, vnext_op_counts

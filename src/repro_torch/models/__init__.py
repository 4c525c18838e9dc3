"""Dense transformer blocks and the paged-decode model facade."""

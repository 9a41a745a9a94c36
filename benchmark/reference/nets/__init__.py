"""The plain reference of the training cells: the PointNet heads and their
losses written out in plain PyTorch, and frozen copies of the category
symmetry tables and of the packed-split readers (the batches are those
readers' draws from their seeded streams).  Nothing here imports the port."""

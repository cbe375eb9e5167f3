"""Evaluation metrics of the port: the confusion matrix on the card and the
detectron2 mIoU family on the host."""

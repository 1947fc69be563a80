from .accuracy import (confusion_matrix, get_weighted_score,
                       mean_average_precision, mean_class_accuracy,
                       mmit_mean_average_precision, per_class_accuracy,
                       top_k_accuracy, top_k_classes)
from .visualizer import ClfVisualizer

__all__ = ['confusion_matrix', 'mean_average_precision',
           'mean_class_accuracy', 'mmit_mean_average_precision',
           'per_class_accuracy', 'top_k_accuracy', 'top_k_classes',
           'get_weighted_score', 'ClfVisualizer']

from .cross_entropy_loss import CrossEntropyLossTorch, cross_entropy

__all__ = ['CrossEntropyLossTorch', 'cross_entropy']

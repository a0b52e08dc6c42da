from .regions import Regions, parse_prompts, BaseDetector, StubDetector
from .wordpiece import WordPieceTokenizer


def load_grounded_sam(dino_path: str, sam_path: str, vocab_path: str, **kw):
    """Load the GroundingDINO+SAM detector from local checkpoints."""
    from .grounded import GroundedSamDetector
    return GroundedSamDetector.from_pretrained(dino_path, sam_path,
                                               vocab_path, **kw)

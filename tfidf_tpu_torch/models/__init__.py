from tfidf_tpu_torch.models.base import ScoringModel, get_model
from tfidf_tpu_torch.models.bm25 import BM25Model, int_to_byte4, byte4_to_int
from tfidf_tpu_torch.models.tfidf import TfidfModel, TfidfCosineModel

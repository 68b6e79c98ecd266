from repro_torch.rdf.dictionary import Dictionary, RDF_TYPE, RDFS_SUBCLASSOF
from repro_torch.rdf.graph import LabeledGraph
from repro_torch.rdf.transform import direct_transform, type_aware_transform
from repro_torch.rdf.triples import TripleStore

__all__ = [
    "Dictionary",
    "LabeledGraph",
    "TripleStore",
    "direct_transform",
    "type_aware_transform",
    "RDF_TYPE",
    "RDFS_SUBCLASSOF",
]

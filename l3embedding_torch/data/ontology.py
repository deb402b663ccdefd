"""AudioSet ontology graph (a copy of ``l3embedding_tpu/data/ontology.py``;
reference audioset/ontology.py:5-137).

Pure host-side Python: nodes with parent/child links, abstract/blacklist
restriction flags, name↔id lookup, and descendant queries. The
descendant check here is iterative (explicit stack) rather than the
reference's recursive DFS, and memoizes nothing — the ontology is ~600
nodes, so a linear walk is fine.
"""

from __future__ import annotations

import json
import os


class OntologyNode:
    def __init__(self, ontology, data: dict):
        self.ontology = ontology
        self.id = data["id"]
        self.name = data["name"]
        self.description = data.get("description", "")
        self.citation_uri = data.get("citation_uri", "")
        self.positive_examples = data.get("positive_examples", [])
        self.child_ids = data.get("child_ids", [])
        restrictions = data.get("restrictions", [])
        self.abstract = "abstract" in restrictions
        self.blacklist = "blacklist" in restrictions
        self.parent_id = None

    @property
    def children(self):
        return [self.ontology.get_node(cid) for cid in self.child_ids]

    @property
    def parent(self):
        return (
            None if self.parent_id is None else self.ontology.get_node(self.parent_id)
        )

    def is_child(self, other) -> bool:
        """True if `other` is a (transitive) descendant of this node."""
        other = self.ontology.ensure_node(other)
        stack = list(self.child_ids)
        seen = set()
        while stack:
            cid = stack.pop()
            if cid in seen:
                continue
            seen.add(cid)
            if cid == other.id:
                return True
            stack.extend(self.ontology.get_node(cid).child_ids)
        return False

    def is_parent(self, other) -> bool:
        return self.ontology.ensure_node(other).is_child(self)


class ASOntology:
    def __init__(self, ontology_path: str):
        if not os.path.exists(ontology_path):
            raise ValueError(f'Cannot find ontology at "{ontology_path}"')
        with open(ontology_path) as f:
            items = json.load(f)

        self._nodes = {item["id"]: OntologyNode(self, item) for item in items}
        self._name_to_id = {}
        for node in self._nodes.values():
            self._name_to_id[node.name] = node.id
            for cid in node.child_ids:
                self._nodes[cid].parent_id = node.id
        self.top_level_node_ids = [
            n.id for n in self._nodes.values() if n.parent_id is None
        ]

    @property
    def top_level_nodes(self):
        return [self.get_node(nid) for nid in self.top_level_node_ids]

    def ensure_node(self, node):
        return node if isinstance(node, OntologyNode) else self.get_node(node)

    def get_node(self, node_id: str) -> OntologyNode:
        if node_id not in self._nodes:
            raise ValueError(f"No node with ID {node_id}")
        return self._nodes[node_id]

    def get_node_by_name(self, name: str) -> OntologyNode:
        if name not in self._name_to_id:
            raise ValueError(f"No node with name {name}")
        return self._nodes[self._name_to_id[name]]

    def get_node_by_name_ci(self, name: str) -> OntologyNode:
        """Case-insensitive name lookup (labels are lower-cased by the
        subset builder, reference subsets.py:118)."""
        if name in self._name_to_id:
            return self._nodes[self._name_to_id[name]]
        lowered = name.lower()
        for n, nid in self._name_to_id.items():
            if n.lower() == lowered:
                return self._nodes[nid]
        raise ValueError(f"No node with name {name}")


# Backwards-compatible alias matching the reference class name pair.
ASOntologyNode = OntologyNode

# The AudioSet ontology shipped with the repo (the 01 stage's default).
DEFAULT_ONTOLOGY = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "resources", "ontology.json",
)
